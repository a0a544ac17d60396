"""Shared helpers of the port's parity tests (tests/test_torch_*.py)."""
import numpy as np
import pytest
import torch


def t(a, dtype=None):
    """numpy (or jax) array -> CPU torch tensor."""
    return torch.from_numpy(np.array(a)).to(dtype=dtype)


def n(x):
    """torch tensor -> float32 numpy array."""
    return x.detach().float().cpu().numpy()


@pytest.fixture
def cuda():
    """The card, or a skip. Decided inside the test run, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def cross_ids(rng, B, Sq, Sk, n_docs, *, orphan=True):
    """numpy (seg_q, seg_k, pos_q, pos_k), (B, Sq) and (B, Sk), as an
    encoder-decoder's cross-attention sees them: documents 1..n_docs on each
    side of random lengths, then padding; with `orphan`, one more query
    document whose segment id no key has (a transcript without its clip)."""
    def side(S, n):
        cuts = np.sort(rng.choice(np.arange(1, S - 2), size=n, replace=False))
        seg, pos = np.zeros(S, np.int32), np.zeros(S, np.int32)
        for i, (a, b) in enumerate(zip((0, *cuts[:-1]), cuts)):
            seg[a:b], pos[a:b] = i + 1, np.arange(b - a)
        return seg, pos
    rows = [(*side(Sq, n_docs + orphan), *side(Sk, n_docs)) for _ in range(B)]
    seg_q, pos_q, seg_k, pos_k = (np.stack(x) for x in zip(*rows))
    return seg_q, seg_k, pos_q, pos_k
