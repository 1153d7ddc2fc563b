"""Share of the traced window's device-busy time spent in cuDNN's GRU
kernel, found by name (``RNN_blockPersist_fp_GRU``: one launch runs a GRU
over all its steps; GTCRN's intra BiGRU, inter GRU and TRA GRUs, through
``nn/core.GRU``).  A kernel's name does not depend on who enqueued it, so
the share reads the same whether the layered model runs as it comes or as
a replayed CUDA graph, where the program's ``gtcrn.*`` spans do not open.
Overlap with other streams is not removed (the offline path runs on one).
None where no such kernel ran in the window."""

KERNELS = ("RNN_blockPersist_fp_GRU",)


def read(t):
    gru = t.device_s(KERNELS)
    if gru <= 0 or t.busy_s <= 0:
        return None
    return 100 * gru / t.busy_s
