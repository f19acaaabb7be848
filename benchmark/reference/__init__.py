"""The plain reference: float32 PyTorch and NumPy, TF32 off.

It imports nothing of the program (faststyle_tpu_torch) and takes nothing
that the program made: the weights come from their files or from the
benchmark, and what the program derives from them (phase kernels, packed
frames, target Grams, decoded batches) is worked out here again. Each
product (convolution or matrix product) takes a `precision`: "float32", or
a lower one for the control ("tf32", "bfloat16", "float8"), which rounds
the product's operands to it (and on a card, for "tf32", lets cuDNN and
cuBLAS run TF32 too).
"""
