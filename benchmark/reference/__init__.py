"""The plain reference: PyTorch in f32 (TF32 off), written from the
published architecture and the optimizer's definition, importing
nothing of the program (``tdax_torch``) and nothing of ``tdax``.  It is
handed the same weights and inputs the benchmark hands the program and
works out again whatever the program derives from them (int8 scales,
parameters after an update)."""
