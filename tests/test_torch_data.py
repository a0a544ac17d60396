"""The port's copies of the jax-free modules give the reference's results:
the same packed batches from the same seed, the same packing statistics, the
same config registry entry and the same Eq. 1 fit."""
import dataclasses

import numpy as np
import pytest

from repro.configs import get_arch, reduced
from repro.core.detector.predictor import MicroBatchTimePredictor as JPredictor
from repro.data.packing import pack_documents as j_pack_documents, pack_stats as j_pack_stats
from repro.data.synth import SyntheticPackedDataset as JDataset
from repro_torch.configs import get_arch as t_get_arch, reduced as t_reduced
from repro_torch.core.detector.predictor import MicroBatchTimePredictor
from repro_torch.data.packing import pack_documents, pack_stats
from repro_torch.data.synth import SyntheticPackedDataset


def test_qwen3_config_is_the_reference_config():
    fields = dataclasses.astuple  # the two packages' classes differ; their fields must not
    assert fields(t_get_arch("qwen3-8b")) == fields(get_arch("qwen3-8b"))
    assert fields(t_reduced(t_get_arch("qwen3-8b"))) == fields(reduced(get_arch("qwen3-8b")))
    assert t_get_arch("qwen3-8b").padded_vocab == 152064


@pytest.mark.parametrize("seq_len,batch,seed", [(64, 2, 0), (4096, 2, 0), (512, 4, 7)])
def test_same_batches_from_same_seed(seq_len, batch, seed):
    cfg = reduced(get_arch("qwen3-8b"))
    ours = SyntheticPackedDataset(t_reduced(t_get_arch("qwen3-8b")), seq_len, batch, seed=seed)
    ref = JDataset(cfg, seq_len, batch, seed=seed)
    for i in range(3):
        a, b = next(ours), next(ref)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
        assert pack_stats(a["segment_ids"]) == j_pack_stats(b["segment_ids"])
    assert ours.state() == ref.state()


def test_pack_documents_matches(rng):
    lens = rng.integers(1, 300, size=200)
    for strategy in ("first_fit", "first_fit_decreasing"):
        assert pack_documents(lens, 256, strategy=strategy) == j_pack_documents(lens, 256, strategy=strategy)


def test_predictor_fit_matches(rng):
    ours, ref = MicroBatchTimePredictor(), JPredictor()
    samples = []
    for _ in range(12):
        n, l2 = int(rng.integers(1000, 8000)), int(rng.integers(10**5, 10**7))
        t = 3e-6 * n + 1e-8 * l2 + 0.2
        ours.observe(n, l2, t)
        ref.observe(n, l2, t)
        samples.append((n, l2, 1, t))
    ours.fit()
    ref.fit()
    assert (ours.alpha, ours.beta, ours.gamma) == (ref.alpha, ref.beta, ref.gamma)
    assert ours.mape(samples) == ref.mape(samples) < 1e-6
