"""Share of the traced window's device-busy time spent in TF-GridNet's
full-band attention: the kernels of its one
``scaled_dot_product_attention`` a block, found by name (``KERNELS``: the
memory-efficient attention's forward kernel, which runs float32 with a key
mask; no other layer of the offline path launches it).  A kernel's name does
not depend on who enqueued it, so the share reads the same whether the model
runs as it comes or as a replayed CUDA graph.  None where no such kernel
ran in the window."""

KERNELS = ("fmha_cutlassF",)


def device_s(t) -> float:
    """Device seconds of the attention's kernels in the window."""
    return t.device_s(KERNELS)


def read(t):
    attn = device_s(t)
    if attn <= 0 or t.busy_s <= 0:
        return None
    return 100 * attn / t.busy_s
