"""Unit tests for the small observability utilities (SURVEY.md §5)."""

import json

import jax.numpy as jnp

from drt_tpu.utils.logging import MetricsLogger, Progress
from drt_tpu.utils.profiling import mrays_per_second, rays_per_second, timed


def test_metrics_logger_jsonl(tmp_path):
    path = tmp_path / "m.jsonl"
    log = MetricsLogger(str(path), stream=None)
    log.log(0, loss=1.5, note="warmup")
    log.log(1, loss=jnp.asarray(0.25))
    log.close()
    recs = [json.loads(line) for line in open(path)]
    assert [r["step"] for r in recs] == [0, 1]
    assert recs[0]["loss"] == 1.5 and recs[0]["note"] == "warmup"
    assert recs[1]["loss"] == 0.25
    assert all("t" in r for r in recs)


def test_progress_line(capsys):
    import sys

    p = Progress(total=4, stream=sys.stderr)
    p.update(2)
    p.finish()
    err = capsys.readouterr().err
    assert "50.00%" in err


def test_timed_and_rates():
    calls = []

    def fn(x):
        calls.append(x)
        return x + 1

    median, out = timed(fn, jnp.asarray(1.0), warmup=1, reps=2)
    assert float(out) == 2.0
    assert median >= 0 and len(calls) == 3
    assert rays_per_second(1_000_000, 2.0) == 500_000
    assert mrays_per_second(2_000_000, 1.0) == 2.0
