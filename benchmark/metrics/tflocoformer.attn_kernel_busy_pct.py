"""Share of the traced window's device-busy time spent in TF-Locoformer's
attention: the kernels of the ``scaled_dot_product_attention`` of both of
each block's paths (along frequency over every frame's bins, along time
over every bin's frames with a key mask), found by name (``KERNELS``: the
memory-efficient attention's forward kernels, which run float32; no other
layer of the model launches them).  A kernel's name does not depend on who
enqueued it, so the share reads the same whether the model runs as it
comes or as a replayed CUDA graph.  None where no such kernel ran in the
window."""

KERNELS = ("fmha_cutlassF",)


def device_s(t) -> float:
    """Device seconds of the attention's kernels in the window."""
    return t.device_s(KERNELS)


def read(t):
    attn = device_s(t)
    if attn <= 0 or t.busy_s <= 0:
        return None
    return 100 * attn / t.busy_s
