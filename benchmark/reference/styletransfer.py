"""Fast neural style (Johnson et al., arXiv:1603.08155) as in ShaderNN's
candy-9: a ``stem_kernel`` conv to widths[0]; stride-2 convs up the
``widths``; ``residual_blocks`` blocks of two convs at widths[-1]; stride-2
transposed convs back down the widths; a ``head_kernel`` conv to the
channels. Every conv but the head is followed by an instance norm with a
ReLU, except a block's second, whose norm is linear before the add."""

from __future__ import annotations


def layers(cfg: dict) -> list:
    c, w = cfg["channels"], list(cfg["widths"])
    eps, k, s = cfg["norm_epsilon"], cfg["kernel"], cfg["stride"]
    out = []

    def conv(name, op, kk, ci, co, stride, norm_act):
        out.append({"name": f"{name}_conv", "op": op, "k": kk, "cin": ci, "cout": co,
                    "stride": stride, "act": "linear"})
        out.append({"name": f"{name}_in", "op": "instance_norm", "c": co, "eps": eps,
                    "act": norm_act})

    conv("stem", "conv", cfg["stem_kernel"], c, w[0], 1, "relu")
    for i in range(1, len(w)):
        conv(f"down{i}", "conv", k, w[i - 1], w[i], s, "relu")
    for b in range(cfg["residual_blocks"]):
        skip = out[-1]["name"]
        conv(f"res{b}_1", "conv", k, w[-1], w[-1], 1, "relu")
        conv(f"res{b}_2", "conv", k, w[-1], w[-1], 1, "linear")
        out.append({"name": f"res{b}_add", "op": "add", "skip": skip, "act": "linear"})
    for i in range(len(w) - 1, 0, -1):
        conv(f"up{len(w) - i}", "conv_transpose", k, w[i], w[i - 1], s, "relu")
    out.append({"name": "head", "op": "conv", "k": cfg["head_kernel"], "cin": w[0], "cout": c,
                "stride": 1, "act": "linear"})
    return out
