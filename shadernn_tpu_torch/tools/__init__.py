"""Tools of the port: model conversion (convert, onnx_reader, onnx_export),
layer dumps (dump_reader), comparison (compare), the trainers' data
generators and the launch sweeps."""
