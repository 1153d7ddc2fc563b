"""The reader of ``tfgridnet.lstm_kernel_busy_pct`` on planted traces: the
port's LSTM kernel found by name, its share of the busy time where it ran,
and nothing to read where the full-band BiLSTM ran aten's loop."""

from __future__ import annotations

import pytest

from benchmark.tests.test_harness_tfgridnet import _reader, _trace

LSTM_KERNEL = "(anonymous namespace)::lstm_layer((anonymous namespace)::Args)"


def test_lstm_kernel_reader_reads_its_kernel_by_name():
    # busy [0, 30) conv, [40, 70) the kernel, [60, 90) aten's cell, [150, 160) the kernel
    t = _trace(0, 1_000_000, [("conv", 0, 30), (LSTM_KERNEL, 40, 70),
                              ("lstm_cell_forward", 60, 90), (LSTM_KERNEL, 150, 160)])
    assert _reader("tfgridnet.lstm_kernel_busy_pct")(t) == pytest.approx(100 * 40 / 90)
    # aten's loop alone (a program without the kernel): nothing to read
    aten = _trace(0, 200, [("gemm", 0, 30), ("lstm_cell_forward", 30, 40)])
    assert _reader("tfgridnet.lstm_kernel_busy_pct")(aten) is None
