"""Port's norms, rotary embeddings and SwiGLU MLP against the JAX functions,
float32, same numpy inputs (tolerance 1e-6)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch, reduced
from repro.models import layers as jl
from repro.models.mlp import init_mlp as j_init_mlp, mlp as j_mlp
from repro.parallel.sharding import NULL_POLICY, split_annotations
from repro_torch.configs import get_arch as t_get_arch, reduced as t_reduced
from repro_torch.models import layers as tl
from repro_torch.models.mlp import mlp as t_mlp

from torch_helpers import n, t

TOL = 1e-6


@pytest.mark.parametrize("shape", [(2, 5, 64), (2, 5, 4, 16)])
def test_rms_norms_match(rng, shape):
    x = rng.normal(size=shape).astype(np.float32) * 3.0
    w = rng.normal(size=shape[-1:]).astype(np.float32) * 0.1
    j_fn, t_fn = (jl.rms_norm, tl.rms_norm) if len(shape) == 3 else (jl.head_rms_norm, tl.head_rms_norm)
    ref = np.asarray(j_fn(jnp.asarray(x), jnp.asarray(w), 1e-6))
    out = n(t_fn(t(x), t(w), 1e-6))
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=TOL)


def test_rms_norm_keeps_dtype():
    x = torch.randn(3, 8, dtype=torch.bfloat16)
    assert tl.rms_norm(x, torch.zeros(8)).dtype == torch.bfloat16


@pytest.mark.parametrize("theta,dh,sections", [
    pytest.param(1e6, 16, None, id="1000000.0-16"),
    pytest.param(1e4, 128, None, id="10000.0-128"),
    # M-RoPE: reduced qwen2-vl's sections, and qwen2-vl-7b's at head_dim 128
    pytest.param(1e6, 16, (2, 3, 3), id="mrope-1000000.0-16"),
    pytest.param(1e6, 128, (16, 24, 24), id="mrope-1000000.0-128"),
])
def test_rope_matches(rng, theta, dh, sections):
    """Angles and rotated heads; with `sections`, (B,S,3) positions whose t,
    h and w axes differ, each frequency slot taking its section's axis."""
    shape = (2, 7) if sections is None else (2, 7, 3)
    pos = rng.integers(0, 64, size=shape).astype(np.int32)
    x = rng.normal(size=(2, 7, 4, dh)).astype(np.float32)
    ang_j = jl.rope_angles(jnp.asarray(pos), dh, theta, sections)
    ang_t = tl.rope_angles(t(pos), dh, theta, sections)
    if sections is not None:  # slot i of section a reads axis a
        first = np.cumsum((0,) + sections[:-1])
        for a, i in enumerate(first):
            np.testing.assert_allclose(n(ang_t)[..., i], pos[..., a] * theta ** (-i / (dh // 2)),
                                       rtol=1e-5)
    np.testing.assert_allclose(n(ang_t), np.asarray(ang_j), atol=TOL, rtol=TOL)
    ref = np.asarray(jl.apply_rope(jnp.asarray(x), ang_j))
    out = n(tl.apply_rope(t(x), ang_t))
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=TOL)


def test_mrope_refuses_sections_off_the_head_width():
    with pytest.raises(ValueError, match="do not sum"):
        tl.rope_angles(torch.zeros((1, 2, 3), dtype=torch.int32), 128, 1e6, (2, 3, 3))


def test_swiglu_mlp_matches(rng):
    cfg = reduced(get_arch("qwen3-8b"))
    p, _ = split_annotations(j_init_mlp(jax.random.PRNGKey(3), cfg))
    x = rng.normal(size=(2, 6, cfg.d_model)).astype(np.float32)
    ref = np.asarray(j_mlp(cfg, p, jnp.asarray(x), NULL_POLICY))
    tp = {k: t(v) for k, v in p.items()}
    out = n(t_mlp(t_reduced(t_get_arch("qwen3-8b")), tp, t(x)))
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=TOL)


def test_dense_init_law():
    g = torch.Generator().manual_seed(0)
    w = tl.dense_init(g, (64, 8, 32), in_axis=(0, 1), device="cpu")
    assert w.shape == (64, 8, 32) and w.dtype == torch.float32
    assert abs(float(w.std()) - 1 / np.sqrt(64 * 8)) < 0.05 / np.sqrt(64 * 8)
    g2 = torch.Generator().manual_seed(0)
    assert torch.equal(w, tl.dense_init(g2, (64, 8, 32), in_axis=(0, 1), device="cpu"))
