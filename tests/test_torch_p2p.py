"""The port's copy of Fig. 7's P2P rule (`repro_torch.core.scheduler.p2p`)
held to `repro.core.scheduler.p2p` on the reference's own cases
(tests/test_p2p.py): the mapping at power-of-two degrees 1-8, its coverage
and balance, the slow-fabric bytes and seconds, the chunk slices and the
non-power-of-two refusal, all equal exactly; and the engine's routes
(`engine.pipeline.boundary_routes`) built from them."""
import itertools
from collections import Counter

import pytest

from repro.configs import get_arch as j_get_arch
from repro.core.scheduler import p2p as ref
from repro_torch.configs import get_arch
from repro_torch.core.scheduler import p2p
from repro_torch.engine.pipeline import boundary_routes

POW2 = [1, 2, 4, 8]
PAIRS = list(itertools.product(POW2, POW2))


@pytest.mark.parametrize("ts,tr", PAIRS)
def test_mapping_matches_reference(ts, tr):
    """Every chunk once, chunk c from sender c*ts//n to receiver c*tr//n,
    each sender n/ts chunks and each receiver n/tr: the reference's list."""
    mapping = p2p.p2p_mapping(ts, tr)
    assert mapping == ref.p2p_mapping(ts, tr)
    n = max(ts, tr)
    assert sorted(c for _, _, c in mapping) == list(range(n))
    assert all(s == c * ts // n and r == c * tr // n for s, r, c in mapping)
    assert set(Counter(s for s, _, _ in mapping).values()) == {n // ts}
    assert set(Counter(r for _, r, _ in mapping).values()) == {n // tr}


@pytest.mark.parametrize("ts,tr", PAIRS)
@pytest.mark.parametrize("scatter_gather", [True, False])
def test_bytes_and_time_match_reference(ts, tr, scatter_gather):
    for t in (2**20, 10 * 2**20, 1 * 4096 * 4096 * 2):
        assert (p2p.p2p_cost_bytes(t, ts, tr, scatter_gather=scatter_gather)
                == ref.p2p_cost_bytes(t, ts, tr, scatter_gather=scatter_gather))
        assert (p2p.p2p_time(t, ts, tr, scatter_gather=scatter_gather)
                == ref.p2p_time(t, ts, tr, scatter_gather=scatter_gather))
        fabric = p2p.Fabric(slow_bw=50e9, fast_bw=900e9, latency=5e-6)
        j_fabric = ref.Fabric(slow_bw=50e9, fast_bw=900e9, latency=5e-6)
        assert (p2p.p2p_time(t, ts, tr, fabric, scatter_gather=scatter_gather)
                == ref.p2p_time(t, ts, tr, j_fabric, scatter_gather=scatter_gather))
    t = 10 * 2**20
    assert p2p.p2p_cost_bytes(t, ts, tr) == t  # each chunk crosses once
    assert p2p.p2p_cost_bytes(t, ts, tr, scatter_gather=False) == tr * t
    assert p2p.p2p_time(2**20, ts, tr) < p2p.p2p_time(2**24, ts, tr)
    if tr > 1:  # scatter/gather beats naive for any multi-rank receiver
        assert (p2p.p2p_time(2**24, ts, tr, scatter_gather=True)
                < p2p.p2p_time(2**24, ts, tr, scatter_gather=False))


def test_fabric_defaults_and_boundary_bytes_match_reference():
    assert p2p.Fabric() == p2p.Fabric(*vars(ref.Fabric()).values())
    for arch in ("qwen3-8b", "llama2-7b", "gemma3-1b"):
        for tokens, width in ((4096, 2), (2 * 4096, 4)):
            assert (p2p.boundary_bytes(get_arch(arch), tokens, width)
                    == ref.boundary_bytes(j_get_arch(arch), tokens, width))
    # the card's qwen3-8b plan: a 1 x 4096 micro-batch in bf16 is 32 MiB
    assert p2p.boundary_bytes(get_arch("qwen3-8b"), 4096) == 32 * 2**20


@pytest.mark.parametrize("ts,tr", PAIRS)
@pytest.mark.parametrize("dim", [1024, 4096, 64])
def test_chunk_slices_match_reference(ts, tr, dim):
    slices = p2p.chunk_slices(dim, ts, tr)
    assert slices == ref.chunk_slices(dim, ts, tr)
    assert len(slices) == max(ts, tr)
    assert [i for sl in slices for i in range(sl.start, sl.stop)] == list(range(dim))


@pytest.mark.parametrize("ts,tr", [(3, 2), (2, 3), (6, 4)])
def test_non_pow2_rejected(ts, tr):
    for mod in (p2p, ref):
        with pytest.raises(AssertionError):
            mod.p2p_mapping(ts, tr)
    assert boundary_routes(ts, tr, 1024) is None  # the engine moves such a pair whole


@pytest.mark.parametrize("ts,tr", PAIRS)
def test_engine_routes_follow_the_mapping(ts, tr):
    """The hand-off's routes: chunk c of the mapping with its slice; each
    receiver's chunks one contiguous block of width/tr columns; a width
    that n does not divide is moved whole (None)."""
    routes = boundary_routes(ts, tr, 4096)
    mapping = p2p.p2p_mapping(ts, tr)
    slices = p2p.chunk_slices(4096, ts, tr)
    assert routes == [(s, r, slices[c]) for s, r, c in mapping]
    for r in range(tr):
        mine = [cut for _, b, cut in routes if b == r]
        assert all(a.stop == b.start for a, b in zip(mine, mine[1:]))
        assert (mine[0].start, mine[-1].stop) == (r * 4096 // tr, (r + 1) * 4096 // tr)
    if max(ts, tr) > 1:
        assert boundary_routes(ts, tr, 4096 + 1) is None
