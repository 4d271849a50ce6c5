"""RenderConfig validation (hardened edges: absorb_prob=1 would make the
RR reweighting infinite, ragged spp chunks silently mis-chunk, etc.)."""

import pytest

from drt_tpu.config import RenderConfig


def test_defaults_are_valid():
    cfg = RenderConfig()
    assert cfg.width == 640 and cfg.absorb_prob == 0.5


@pytest.mark.parametrize("kwargs,match", [
    (dict(absorb_prob=1.0), "absorb_prob"),
    (dict(absorb_prob=-0.1), "absorb_prob"),
    (dict(spp=5, spp_chunks=2), "spp_chunks"),
    (dict(spp_chunks=0), "spp_chunks"),
    (dict(min_bounces=9, max_depth=8), "min_bounces"),
    (dict(min_bounces=-1), "min_bounces"),
    (dict(width=0), "positive"),
    (dict(spp=0), "positive"),
    (dict(max_depth=0), "max_depth"),
    (dict(bsdf_samples=0), "bsdf_samples"),
    (dict(adjoint_samples=0), "adjoint_samples"),
])
def test_invalid_configs_rejected(kwargs, match):
    with pytest.raises(ValueError, match=match):
        RenderConfig(**kwargs)


def test_boundary_values_accepted():
    RenderConfig(absorb_prob=0.0, min_bounces=0)
    RenderConfig(min_bounces=8, max_depth=8)
    RenderConfig(spp=8, spp_chunks=8)
    RenderConfig(width=64, height=48, spp=4, max_depth=5,
                 bsdf_samples=2, adjoint_samples=4)


def test_splitting_lane_budget_guard():
    """bsdf_samples=2 at the default max_depth=32 demands 2^31 leaf
    lanes per ray — must be a config error, not an OOM."""
    with pytest.raises(ValueError, match="leaf lanes"):
        RenderConfig(bsdf_samples=2)
    with pytest.raises(ValueError, match="leaf lanes"):
        # Modest splitting, but the ray count pushes total lanes over.
        RenderConfig(width=640, height=480, spp=100, max_depth=5,
                     bsdf_samples=4)
    # Small scenes with shallow trees stay fine.
    RenderConfig(width=64, height=48, spp=8, max_depth=4, bsdf_samples=3)


class _Device:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize("stats,budget", [
    ({"bytes_limit": 60 << 30}, 30 << 30),
    ({"bytes_limit": 12 << 30, "peak_bytes_in_use": 0}, 6 << 30),
    (None, 1 << 33),
])
def test_split_budget_follows_device_memory(monkeypatch, stats, budget):
    """The splitting budget is half the device's reported memory limit,
    or the fixed default where the device reports none (the CPU)."""
    import jax

    from drt_tpu import config

    monkeypatch.setattr(jax, "devices", lambda: [_Device(stats)])
    assert config.max_split_bytes() == budget
    # 2187 lanes/ray x 24576 rays x 288 B = 15.5 GB: fits only the card.
    kw = dict(width=64, height=48, spp=8, max_depth=8, bsdf_samples=3)
    if budget > 16e9:
        RenderConfig(**kw)
    else:
        with pytest.raises(ValueError, match="leaf lanes"):
            RenderConfig(**kw)
