"""The work of TF-GridNet (ESPnet ``TFGridNet``, ``emb_hs`` 1), counted from
its shapes alone: the multiply-adds of the contractions, not the norms',
PReLUs' or gates' elementwise work.

A frame of one block, at a clip of T frames (F bins, D channels, H units a
direction, unfold of I, L heads of E query and key channels):

- intra BiLSTM: (F - I + 1) windows x 2 directions x 4 H (D I + H);
- inter BiLSTM: F x 2 x 4 H (D I + H) (a clip has T - I + 1 windows; a
  frame is counted as one);
- the two transposed convs: (F - I + 1 + F) x 2 H x D x I;
- the 1x1 convs: F D (2 L E + D) for Q, K, V and F D D for the projection;
- attention: L (E F + (D / L) F) for each of the T key frames.

Plus, once a frame, the input conv (F x 9 x 2 D) and the output transposed
conv (F x 9 x 2 D).  At the published widths a frame is 1,020,212,928
multiply-adds of layers (1,019,990,016 in the blocks) and 49,536 T of
attention.  ``utils/complexity``
counts the forward over a whole clip instead: its inter BiLSTM over the
T - I + 1 windows only, and every contraction it calls (the same set).
"""

from __future__ import annotations


def frame_macs(T: int, n_freqs: int = 129, emb_dim: int = 48, hidden: int = 192,
               emb_ks: int = 4, n_head: int = 4, qk_dim: int = 4, n_layers: int = 6) -> int:
    """Multiply-adds of one frame of a clip of ``T`` frames."""
    F, D, H, k, L, E = n_freqs, emb_dim, hidden, emb_ks, n_head, qk_dim
    lstm = 2 * 4 * H * (D * k + H)
    block = ((F - k + 1) * lstm + F * lstm
             + (F - k + 1 + F) * 2 * H * D * k
             + F * D * (2 * L * E + D) + F * D * D
             + L * (E * F + D // L * F) * T)
    return n_layers * block + 2 * F * 9 * 2 * D


def call_macs(lengths, **sizes) -> int:
    """Multiply-adds of one call over clips of ``lengths`` frames (their own
    frames, not the buckets' padding)."""
    return sum(T * frame_macs(T, **sizes) for T in lengths)


def attn_flops(pairs: int, n_freqs: int = 129, emb_dim: int = 48, hidden: int = 192,
               emb_ks: int = 4, n_head: int = 4, qk_dim: int = 4, n_layers: int = 6) -> int:
    """FLOPs of the attention's two matmuls over ``pairs`` query-key frame
    pairs of a batch (every block, every head): 2 x B x L x (E F + (D / L) F)
    a pair, 99,072 at the published widths (``hidden`` and ``emb_ks`` do not
    enter)."""
    del hidden, emb_ks
    return 2 * n_layers * n_head * (qk_dim * n_freqs + emb_dim // n_head * n_freqs) * pairs



def sizes_of(config: dict) -> dict:
    """The widths of a benchmark configuration's file, as the keywords of
    :func:`frame_macs`, :func:`call_macs` and :func:`attn_flops`."""
    return dict(n_freqs=config["n_freqs"], emb_dim=config["emb_dim"],
                hidden=config["lstm_hidden_units"], emb_ks=config["emb_ks"],
                n_head=config["attn_n_head"], qk_dim=config["attn_qk_channels"],
                n_layers=config["n_layers"])
