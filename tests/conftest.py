"""Shared fixtures. NOTE: no XLA_FLAGS here — tests see the real device count
(1 on this container); multi-device paths are exercised via subprocesses."""
import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: heavy jax compile/train tests; tier-1 runs -m 'not slow'")
    config.addinivalue_line("markers", "gpu: needs a CUDA card; skips without one")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def make_packed(rng, B, S, doc_lens=None):
    """Packed (segment_ids, positions) arrays for attention/kernel tests."""
    seg = np.zeros((B, S), np.int32)
    pos = np.zeros((B, S), np.int32)
    for b in range(B):
        lens = doc_lens or []
        if not lens:
            remaining, lens = S, []
            while remaining > 0:
                l = int(rng.integers(max(S // 8, 1), S + 1))
                l = min(l, remaining)
                lens.append(l)
                remaining -= l
        off = 0
        for i, l in enumerate(lens):
            if off + l > S:
                l = S - off
            if l <= 0:
                break
            seg[b, off: off + l] = i + 1
            pos[b, off: off + l] = np.arange(l)
            off += l
    return seg, pos
