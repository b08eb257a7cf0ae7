"""Plain PyTorch references of what the timed paths compute.

They follow the published descriptions, run in float32 with TF32 off,
import nothing of the program, and take their weights from the dicts the
harness made from the seed (``bench_torch.weights``).  ``Numerics("fp8")``
puts each reference one precision below bf16 for the control: every
operand of a convolution or a matrix product is rounded to float8 e4m3
with a per-tensor scale.
"""
