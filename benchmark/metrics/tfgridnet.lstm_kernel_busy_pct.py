"""Share of the traced window's device-busy time spent in the port's LSTM
kernel (``csrc/lstm.cu``, ``lstm_layer``), found by name: one launch runs
a whole bidirectional LSTM layer, TF-GridNet's full-band BiLSTM of every
block.  A kernel's name does not depend on who enqueued it, so the share
reads the same whether the model runs as it comes or as a replayed CUDA
graph.  None where the kernel never ran in the window (a program without
it, whose full-band BiLSTM runs aten's loop)."""

KERNELS = ("lstm_layer",)


def read(t):
    lstm = t.device_s(KERNELS)
    if lstm <= 0 or t.busy_s <= 0:
        return None
    return 100 * lstm / t.busy_s
