"""Seeded synthetic batches of the VLM and encoder-decoder families.

The reference stubs both frontends: a VLM batch carries precomputed vision
patch embeddings, which replace the first S_vis token embeddings of each
row, and 3-axis M-RoPE positions; an encoder-decoder batch carries the
encoder's frame embeddings and a decoder token stream
(`repro.launch.specs.train_batch_specs` gives the shapes). Its
`SyntheticPackedDataset` makes neither, so these do, as numpy arrays from a
seed: embeddings from a standard normal draw, documents packed as
`data.packing.row_to_arrays` packs them (labels the next token of the same
document, -1 elsewhere).
"""
from __future__ import annotations

import numpy as np

from repro_torch.data.packing import row_to_arrays
from repro_torch.data.synth import sample_doc_lengths


def mrope_positions(pos, vision_len, grid):
    """(S,) positions of one row -> (S, 3) M-RoPE positions (t, h, w): a
    vision span at row positions [0, vision_len) laid out on `grid` (rows,
    columns), t the span's first position and h, w its grid row and column
    offset from it; every other position p is (p, p, p), as the reference's
    decode step assumes."""
    rows, cols = grid
    if rows * cols != vision_len:
        raise ValueError(f"grid {grid} does not hold {vision_len} vision embeddings")
    out = np.repeat(pos[:, None], 3, axis=1).astype(np.int32)
    start = pos[0]
    i = np.arange(vision_len)
    out[:vision_len, 0] = start
    out[:vision_len, 1] = start + i // cols
    out[:vision_len, 2] = start + i % cols
    return out


def _fill(rng, first, seq_len, mu, sigma):
    """Document lengths of one row: `first`, then lognormal documents while
    they fit (the rest is padding)."""
    lens, used = [first], first
    while used < seq_len:
        (l,) = sample_doc_lengths(rng, 1, seq_len, mu=mu, sigma=sigma)
        if used + int(l) > seq_len:
            break
        lens.append(int(l))
        used += int(l)
    return lens


def vlm_batch(cfg, seq_len, batch, *, seed, vision_len, grid, index=0, mu=6.2, sigma=1.1):
    """Packed VLM rows: each row's first document opens with `vision_len`
    vision embeddings on `grid` (its labels there -1) and goes on with text;
    lognormal text documents fill the rest. -> tokens, segment_ids, labels
    (B,S), positions (B,S,3), vision_embeds (B, vision_len, d_model) float32."""
    rng = np.random.default_rng((seed, index))
    B, S = batch, seq_len
    out = {k: np.zeros((B, S), np.int32) for k in ("tokens", "segment_ids", "labels")}
    out["positions"] = np.zeros((B, S, 3), np.int32)
    for b in range(B):
        (text,) = sample_doc_lengths(rng, 1, S, mu=mu, sigma=sigma)
        first = min(vision_len + int(text), S)
        row = _fill(rng, first, S, mu, sigma)
        tokens, seg, pos, labels = row_to_arrays(row, S, rng, cfg.vocab_size)
        labels[:vision_len] = -1
        out["tokens"][b], out["segment_ids"][b], out["labels"][b] = tokens, seg, labels
        out["positions"][b] = mrope_positions(pos, vision_len, grid)
    out["vision_embeds"] = rng.standard_normal((B, vision_len, cfg.d_model), dtype=np.float32)
    return out


def enc_dec_batch(cfg, frames, dec_len, batch, *, seed, clip_frames=(300, 1500), index=0):
    """Packed encoder-decoder rows: clips of `clip_frames` (least, most)
    frames drawn uniformly while they fit in `frames`, and in the decoder
    row each clip's transcript of clip_len // cfg.dec_ratio tokens under the
    clip's segment id (while they fit in `dec_len`). -> frame_embeds
    (B, frames, d_model) float32, enc_segment_ids, enc_positions
    (B, frames), dec_tokens, dec_segment_ids, dec_positions, labels
    (B, dec_len)."""
    rng = np.random.default_rng((seed, index))
    B = batch
    out = {k: np.zeros((B, frames), np.int32) for k in ("enc_segment_ids", "enc_positions")}
    out.update({k: np.zeros((B, dec_len), np.int32)
                for k in ("dec_tokens", "dec_segment_ids", "dec_positions", "labels")})
    lo, hi = clip_frames
    for b in range(B):
        clips, used = [], 0
        while True:
            c = int(rng.integers(lo, hi + 1))
            if used + c > frames or sum(x // cfg.dec_ratio for x in clips + [c]) > dec_len:
                break
            clips.append(c)
            used += c
        if not clips:
            raise ValueError(f"no clip of {clip_frames} frames fits {frames} frames and "
                             f"{dec_len} decoder positions")
        off = 0
        for i, c in enumerate(clips):
            out["enc_segment_ids"][b, off:off + c] = i + 1
            out["enc_positions"][b, off:off + c] = np.arange(c)
            off += c
        row = [c // cfg.dec_ratio for c in clips]
        (out["dec_tokens"][b], out["dec_segment_ids"][b], out["dec_positions"][b],
         out["labels"][b]) = row_to_arrays(row, dec_len, rng, cfg.vocab_size)
    out["frame_embeds"] = rng.standard_normal((B, frames, cfg.d_model), dtype=np.float32)
    return out
