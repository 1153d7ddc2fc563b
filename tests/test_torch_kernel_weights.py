"""The CUDA kernels' weight buffer (ops/fused_step.py kernel_weights) and
their band-sparse ERB merge and split, on the CPU at the model's real sizes.

No JAX compile: the JAX package is used only for its ERB matrices (numpy).
Tolerances: the kernel buffer holds the packed values exactly (bit for bit);
a band loop in the dense loop's summation order equals the dense loop
exactly; against ``_erb_features`` / ``_apply_mask`` (a BLAS product, whose
summation order is its own) and a float64 product with the JAX matrices, the
sums of at most 11 float32 products of values below 5 differ by rounding
only, 2e-6.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from gtcrn_micro_tpu_torch.models.gtcrn_micro import init_params
from gtcrn_micro_tpu_torch.ops import fused_step as tfs

CSRC = Path(tfs.__file__).resolve().parent.parent / "csrc"
BANDED = {0: "bm_w", 1: "bs_w"}
TOL = 2e-6


def _header_const(pattern):
    return re.search(pattern, (CSRC / "gtcrn_forward.cuh").read_text()).group(1)


def _group_of(entry, first):
    """The weight group the kernels stage entry with (gtcrn_forward.cuh
    group_of): the last group whose first entry is at most entry; bs_w
    (entry 1) is in the last group."""
    return len(first) - 1 if entry == 1 else max(g for g, e in enumerate(first) if e <= entry)


@pytest.fixture(scope="module")
def params():
    return init_params(torch.Generator().manual_seed(0), device="cpu")


def _table_rows(tbl, rows):
    """(first, length, weights) of each row of a band table."""
    head = tbl[: 3 * rows].reshape(rows, 3).astype(int)
    return [(k0, n, tbl[wo : wo + n]) for k0, n, wo in head]


def _dense_from_table(tbl, shape):
    m = np.zeros(shape, np.float32)
    for r, (k0, n, w) in enumerate(_table_rows(tbl, shape[0])):
        m[r, k0 : k0 + n] = w
    return m


def _entry(kw, i, size):
    return kw.buf[kw.offsets[i] : kw.offsets[i] + size].numpy()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_weights_reproduce_packed_entries(params, dtype):
    """Every entry but the two band tables is the packed entry, widened to
    float32, bit for bit; the band tables rebuild bm_w and bs_w exactly."""
    packed = tfs.pack_weights(params, dtype, device="cpu")
    kw = tfs.kernel_weights(packed)
    assert kw.buf.dtype == torch.float32 and kw.buf.dim() == 1
    assert len(kw.offsets) == tfs.N_WEIGHTS == 158
    for i, e in enumerate(packed.entries()):
        want = e.float().numpy()
        if i in BANDED:
            tbl = kw.buf[kw.offsets[i] :].numpy()
            got = _dense_from_table(tbl, want.shape)
        else:
            got = _entry(kw, i, want.size).reshape(want.shape)
        assert got.view(np.int32).tolist() == want.view(np.int32).tolist(), i
    W = tfs.unpack(packed)
    for i, name in BANDED.items():
        np.testing.assert_array_equal(
            _dense_from_table(kw.buf[kw.offsets[i] :].numpy(), W[name].shape), W[name].numpy())


def test_kernel_weight_entries_aligned_and_groups_fit(params):
    """Every entry starts on 16 bytes; entries do not overlap; each weight
    group (GROUP_FIRST in gtcrn_forward.cuh) is one span of the buffer no
    larger than the kernels' staging buffer (WBUF) and holds every entry of
    the group."""
    packed = tfs.pack_weights(params, device="cpu")
    kw = tfs.kernel_weights(packed)
    sizes = [e.numel() for e in packed.entries()]
    for i in BANDED:
        sizes[i] = 3 * packed.shapes[i][0] + int((packed.entries()[i] != 0).sum())
    order = sorted(range(tfs.N_WEIGHTS), key=lambda i: kw.offsets[i])
    assert tuple(order) == tfs.KERNEL_ORDER
    assert all(kw.offsets[i] % 4 == 0 for i in order)
    for a, b in zip(order, order[1:]):
        assert kw.offsets[a] + sizes[a] <= kw.offsets[b] < kw.offsets[a] + sizes[a] + 4
    assert kw.buf.numel() % 4 == 0
    wbuf = int(_header_const(r"constexpr int WBUF = (\d+);"))
    first = [int(v) for v in _header_const(r"GROUP_FIRST\[N_GROUPS\] = \{([\d, ]+)\};").split(",")]
    assert len(first) == 18 and first == sorted(first)
    bounds = [kw.offsets[i] for i in first] + [kw.buf.numel()]
    spans = np.diff(bounds)
    assert np.all(spans > 0) and spans.max() <= wbuf, spans
    for i in range(tfs.N_WEIGHTS):
        g = _group_of(i, first)
        assert bounds[g] <= kw.offsets[i] and kw.offsets[i] + sizes[i] <= bounds[g + 1], (i, g)


def test_band_tables_hold_every_nonzero(params):
    """Each row's span runs from its first to its last nonzero: every
    nonzero of bm_w and bs_w lies in its row's span, and the spans hold the
    382 nonzeros of each matrix with no zero between them."""
    W = tfs.unpack(tfs.pack_weights(params, device="cpu"))
    for name in ("bm_w", "bs_w"):
        m = W[name].numpy()
        tbl = tfs.band_table(m)
        rows = _table_rows(tbl, m.shape[0])
        for r, (k0, n, w) in enumerate(rows):
            nz = np.flatnonzero(m[r])
            assert nz.size and k0 == nz[0] and k0 + n - 1 == nz[-1], (name, r)
            assert np.all(w != 0), (name, r)
        assert sum(n for _k0, n, _w in rows) == int((m != 0).sum()) == 382
        assert tbl.size == 3 * m.shape[0] + 382


def _band_loop(tbl, rows, x):
    """The kernels' band loop: y[r] = sum over the span of w[k] * x[k0 + k],
    k ascending, in float32."""
    y = np.zeros((rows,) + x.shape[1:], np.float32)
    for r, (k0, n, w) in enumerate(_table_rows(tbl, rows)):
        acc = np.zeros(x.shape[1:], np.float32)
        for k in range(n):
            acc = (acc + np.float32(w[k]) * x[k0 + k]).astype(np.float32)
        y[r] = acc
    return y


def _dense_loop(m, x):
    """The dense product in the same order: every column, ascending."""
    y = np.zeros((m.shape[0],) + x.shape[1:], np.float32)
    for k in range(m.shape[1]):
        y = (y + m[:, k : k + 1] * x[k]).astype(np.float32)
    return y


def test_band_loop_erb_merge_and_split(params):
    """A band loop over the tables equals the dense loop in the same order
    exactly, and matches the plain version's _erb_features and _apply_mask
    and the JAX package's ERB matrices (x @ bm_w, x @ bs_w)."""
    from gtcrn_micro_tpu.dsp.erb import ErbBands

    W = tfs.unpack(tfs.pack_weights(params, device="cpu"))
    bm, bs = W["bm_w"].numpy(), W["bs_w"].numpy()
    jerb = {k: np.asarray(v, np.float64) for k, v in ErbBands().init_params().items()}
    rng = np.random.default_rng(0)
    B = 64
    spec = rng.standard_normal((2, 257, B)).astype(np.float32)
    m = np.tanh(rng.standard_normal((2, 129, B))).astype(np.float32)

    re_, im_ = spec
    mag = np.sqrt(re_ * re_ + im_ * im_ + np.float32(1e-12)).astype(np.float32)
    feats = np.stack([np.concatenate([ch[:65], _band_loop(tfs.band_table(bm), 64, ch[65:])])
                      for ch in (mag, re_, im_)])
    for c, ch in enumerate((mag, re_, im_)):
        np.testing.assert_array_equal(feats[c, 65:], _dense_loop(bm, ch[65:]))
        want = ch[65:].T.astype(np.float64) @ jerb["bm_w"]  # JAX layout (192, 64)
        np.testing.assert_allclose(feats[c, 65:], want.T, rtol=0, atol=TOL)
    np.testing.assert_allclose(
        feats, tfs._erb_features(W, torch.from_numpy(spec)).numpy(), rtol=0, atol=TOL)

    split = np.stack([np.concatenate([m[c, :65], _band_loop(tfs.band_table(bs), 192, m[c, 65:])])
                      for c in range(2)])
    for c in range(2):
        np.testing.assert_array_equal(split[c, 65:], _dense_loop(bs, m[c, 65:]))
        want = m[c, 65:].T.astype(np.float64) @ jerb["bs_w"]  # JAX layout (64, 192)
        np.testing.assert_allclose(split[c, 65:], want.T, rtol=0, atol=TOL)
    mr, mi = split
    masked = np.stack([re_ * mr - im_ * mi, im_ * mr + re_ * mi])
    np.testing.assert_allclose(
        masked, tfs._apply_mask(W, torch.from_numpy(m), torch.from_numpy(spec)).numpy(),
        rtol=0, atol=TOL)
