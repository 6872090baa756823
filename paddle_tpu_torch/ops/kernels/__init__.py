"""The hand-written Hopper kernels: each module holds its wrappers, their
plain PyTorch versions (``*_ref``), a launch count per kernel
(``LAUNCHES[name]``) and a source note.

==========  ===============================  ==================================
kernel      module                           replaces (paddle_tpu/ops/pallas/)
==========  ===============================  ==================================
K-DEC       ``paged_attention``              ``paged_attention._decode_kernel``
K-DEC8      ``paged_attention``              ``paged_attention._decode_kernel``
                                             (``quantized=True``)
K-MQ        ``paged_attention``              ``paged_attention._mq_kernel``
K-MQ8       ``paged_attention``              ``paged_attention._mq_kernel``
                                             (``quantized=True``)
K-SEG       ``flash_attention_packed``       ``flash_attention_packed.
                                             _fwd_kernel_seg``
K-BSHD      ``flash_attention``              ``flash_attention._fwd_kernel``
K-PACK      ``flash_attention_packed``       ``flash_attention_packed.
                                             _fwd_kernel``
K-DQ        ``flash_attention_packed``       ``flash_attention_packed.
                                             _dq_kernel``
K-DKV       ``flash_attention_packed``       ``flash_attention_packed.
                                             _dkv_kernel``
K-SDQ       ``flash_attention_packed``       ``flash_attention_packed.
                                             _dq_kernel_seg``
K-SDKV      ``flash_attention_packed``       ``flash_attention_packed.
                                             _dkv_kernel_seg``
K-BDQ       ``flash_attention``              ``flash_attention._dq_kernel``
K-BDKV      ``flash_attention``              ``flash_attention._dkv_kernel``
==========  ===============================  ==================================

The flash kernels also run with attention dropout and an additive mask
(``csrc/philox.cuh``; ``philox`` holds the keep bits in plain PyTorch):
``variant_counts()`` gives those launches by variant, such as
``"K-BSHD+bias"`` and ``"K-SEG+drop"``, each also counted under its
kernel.
"""
from . import flash_attention, flash_attention_packed, paged_attention, philox

__all__ = ["paged_attention", "flash_attention_packed", "flash_attention",
           "philox", "KERNELS", "reset_launch_counts", "launch_counts",
           "variant_counts"]

# name -> module, serving's kernels first, then training's
KERNELS = {
    "K-DEC": paged_attention,
    "K-DEC8": paged_attention,
    "K-MQ": paged_attention,
    "K-MQ8": paged_attention,
    "K-SEG": flash_attention_packed,
    "K-BSHD": flash_attention,
    "K-PACK": flash_attention_packed,
    "K-DQ": flash_attention_packed,
    "K-DKV": flash_attention_packed,
    "K-SDQ": flash_attention_packed,
    "K-SDKV": flash_attention_packed,
    "K-BDQ": flash_attention,
    "K-BDKV": flash_attention,
}


def reset_launch_counts() -> None:
    for name, mod in KERNELS.items():
        mod.LAUNCHES[name] = 0
    flash_attention_packed.VARIANTS.clear()


def launch_counts() -> dict:
    return {name: mod.LAUNCHES[name] for name, mod in KERNELS.items()}


def variant_counts() -> dict:
    """Launches with dropout or a mask since the last reset, by
    variant."""
    return dict(flash_attention_packed.VARIANTS)
