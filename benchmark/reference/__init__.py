"""Plain PyTorch references of the benchmark's model families.

Nothing here imports the measured program or the JAX package: each family
lists its layers from a configuration's sizes (`layers`), with the ops and
activations of its own that `plain.py`'s tables lack (`OPS`, `ACTS`), and
`plain.py` reads the trained artifact's weight stream and runs those
layers in float32 with TF32 off.
"""
