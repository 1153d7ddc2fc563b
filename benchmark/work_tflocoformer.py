"""The work of TF-Locoformer (MERL ``TFLocoformerSeparator``, conv-SwiGLU
FFNs at stride 1), counted from its shapes alone: the multiply-adds of the
contractions, not the norms', rotations' or gates' elementwise work.

A frame of one block, at a clip of T frames (F bins, C channels, FFN
hidden H, conv kernel k, attention width A over all heads), along
frequency and along time alike:

- the two FFNs: 2 x F x 3 H C k (the conv C -> 2 H and the transposed conv
  H -> C at each position; the k - 1 positions of padding a sequence's
  conv adds at each end are not counted);
- the projections: F x 4 A C (q, k, v and the heads' aggregate);
- attention along frequency: F x F x 2 A (scores and values of each of a
  frame's F queries over its F keys); along time: F x T x 2 A.

Plus, once a frame, the input conv (F x 9 x 2 C) and the output transposed
conv (F x 9 x 2 C).  At the published widths a frame is 1,953,699,840
multiply-adds of layers (1,927,544,832 in the FFNs and projections,
25,560,576 in the attention along frequency) and 198,144 T of attention
along time.  ``utils/complexity`` counts the forward over a whole clip
instead, with each FFN's convs over the S + k - 1 positions of its padded
sequence (the same contractions).
"""

from __future__ import annotations


def frame_macs(T: int, n_freqs: int = 129, emb_dim: int = 128, ffn_hidden: int = 384,
               kernel: int = 4, attention_dim: int = 128, n_layers: int = 6) -> int:
    """Multiply-adds of one frame of a clip of ``T`` frames."""
    F, C, H, k, A = n_freqs, emb_dim, ffn_hidden, kernel, attention_dim
    path = F * (2 * 3 * H * C * k + 4 * A * C)
    block = 2 * path + F * F * 2 * A + F * T * 2 * A
    return n_layers * block + 2 * F * 9 * 2 * C


def call_macs(lengths, **sizes) -> int:
    """Multiply-adds of one call over clips of ``lengths`` frames (their own
    frames, not the buckets' padding)."""
    return sum(T * frame_macs(T, **sizes) for T in lengths)


def attn_flops(pairs: int, frames: int, n_freqs: int = 129, emb_dim: int = 128,
               ffn_hidden: int = 384, kernel: int = 4, attention_dim: int = 128,
               n_layers: int = 6) -> int:
    """FLOPs of the attention's two matmuls (every block, every head) over a
    batch's ``pairs`` query-key frame pairs along time (2 x F x 2 A a pair,
    396,288 at the published widths) and its ``frames`` frames along
    frequency (2 x F^2 x 2 A a frame, 51,121,152); ``emb_dim``,
    ``ffn_hidden`` and ``kernel`` do not enter."""
    del emb_dim, ffn_hidden, kernel
    F, A = n_freqs, attention_dim
    return 2 * n_layers * 2 * A * F * (pairs + F * frames)


def sizes_of(config: dict) -> dict:
    """The widths of a benchmark configuration's file, as the keywords of
    :func:`frame_macs`, :func:`call_macs` and :func:`attn_flops`."""
    return dict(n_freqs=config["n_freqs"], emb_dim=config["emb_dim"],
                ffn_hidden=config["ffn_hidden_dim"], kernel=config["conv1d_kernel"],
                attention_dim=config["attention_dim"], n_layers=config["n_layers"])
