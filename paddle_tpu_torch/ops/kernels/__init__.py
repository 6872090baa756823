"""The hand-written Hopper kernels, one module each: the wrapper, its
plain PyTorch version (``*_ref``), a launch counter and a source note.

==========  ===============================  ==================================
kernel      module                           replaces (paddle_tpu/ops/pallas/)
==========  ===============================  ==================================
K-DEC       ``paged_attention``              ``paged_attention._decode_kernel``
K-SEG       ``flash_attention_packed``       ``flash_attention_packed.
                                             _fwd_kernel_seg``
K-BSHD      ``flash_attention``              ``flash_attention._fwd_kernel``
==========  ===============================  ==================================
"""
from . import flash_attention, flash_attention_packed, paged_attention

__all__ = ["paged_attention", "flash_attention_packed", "flash_attention",
           "KERNELS", "reset_launch_counts", "launch_counts"]

# name -> module, in the order the serving path meets them
KERNELS = {
    "K-DEC": paged_attention,
    "K-SEG": flash_attention_packed,
    "K-BSHD": flash_attention,
}


def reset_launch_counts() -> None:
    for mod in KERNELS.values():
        mod.LAUNCHES = 0


def launch_counts() -> dict:
    return {name: mod.LAUNCHES for name, mod in KERNELS.items()}
