"""The tensor cores' TF32 arithmetic on f32 inputs, emulated on the CPU
for the tests of the kernels that run f32 products as TF32 (one product
per f32 product) or 3xTF32 (three): ``csrc/flash_fwd.cu``,
``csrc/flash_bwd_dkv.cu`` and ``csrc/flash_bwd_dq.cu``. A TF32 operand
keeps 10 of f32's 23 mantissa bits; each product of two TF32 values is
exact in f32, so an f32 matmul of rounded operands is the tensor core's
product up to the order of the f32 sums."""

import torch


def tf32(x, rounded=True):
    """f32 as a TF32 operand: rounded as cvt.rna.tf32.f32 rounds (to
    nearest, ties away from zero: half of the last kept bit added to the
    magnitude), then the 13 dropped bits cleared; or, for an operand
    handed to the tensor core whole, the dropped bits cleared alone."""
    bits = x.contiguous().view(torch.int32)
    if rounded:
        bits = bits + 0x1000
    return (bits & ~0x1FFF).view(torch.float32)


def product(a, b, scheme):
    """a @ b in f32 as the kernels compute it: one TF32 product, or 3xTF32
    (big = tf32(x), small = x - big, of which the tensor core keeps the
    top bits; small*big + big*small + big*big)."""
    a_big, b_big = tf32(a), tf32(b)
    if scheme == "tf32":
        return a_big @ b_big
    a_small = tf32(a - a_big, rounded=False)
    b_small = tf32(b - b_big, rounded=False)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big
