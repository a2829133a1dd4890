"""Tools of the port: model conversion (convert, onnx_reader, onnx_export),
layer dumps (dump_reader), comparison (compare), the trainers (train_*, optim),
the accuracy report and the launch sweeps."""
