"""The benchmark's own tests, on the CPU with the decoder's plain versions
(one test needs the card and skips without one).

    python -m pytest bench_port/tests -q

- a throwaway configuration, traffic mix and metric in a temporary
  folder run through the harness with no edit to any file of bench_port;
- the generator is deterministic per seed;
- the comparison fails on a 1-LSB change of one routed frame, and each
  fault the cells can have (a step that leaves its state unchanged, half
  the streams' PCM left out, an answer altered where it is produced)
  makes a run's `correct` false;
- the control (the reference with a float32 FFT) is found not correct;
- the reference equals tests/golden;
- nothing of the harness or the reference is a JAX module or the JAX
  package (top-level names compared whole), and the reference imports
  nothing of the decoder under test;
- BENCHMARK.json keeps to the benchmark's contract.
"""
from __future__ import annotations

import ast
import json
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench_port"
sys.path.insert(0, str(ROOT))

from bench_port import compare, generator, run, spec  # noqa: E402

CELT = "bench_port/fixtures/celt_fb_stereo_20ms.opus"
CONFIGS = ("music_celt_fb_stereo", "voip_hybrid_swb_mono")


def _tiny(tmp_path, metric_src=None, streams=4, extra_metric=True,
          config="music_celt_fb_stereo"):
    """A benchmark folder `bench` in tmp_path with one tiny cell of a
    configuration's sources."""
    b = tmp_path / "bench"
    for d in ("configs", "traffic", "metrics"):
        (b / d).mkdir(parents=True)
    cfg = json.loads((BENCH / f"configs/{config}.json").read_text())
    cfg["sources"] = [str(ROOT / p) for p in cfg["sources"]]
    (b / "configs/tiny.json").write_text(json.dumps(cfg))
    (b / "traffic/tiny_mix.json").write_text(json.dumps(dict(
        streams=streams, superstep_k=2, warm_steps=3,
        max_steps_per_s=60,
        compare_streams=streams, compare_workers=1)))
    per_layer = []
    if extra_metric:
        (b / "metrics/steps_in_window.py").write_text(metric_src or (
            "def read(run):\n    return float(run.window.steps)\n"))
        per_layer.append(dict(name="steps_in_window", unit="steps",
                              better="higher", source="host_clock",
                              layer="pool step", moves="realtime_streams"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(dict(
        command=["python3", "-m", "bench_port"], paths=["bench"],
        run_seconds=1,
        configs=[dict(name="tiny", source="x", file="bench/configs/tiny.json",
                      reduced=[], why="x")],
        workloads=[dict(name="tiny.mix", config="tiny", traffic="tiny_mix",
                        chips=1, why="x")],
        end_to_end=[dict(name="realtime_streams", unit="audio_s/s",
                         better="higher", bound=0.25, source="host_clock"),
                    dict(name="setup_s", unit="s", better="lower",
                         bound=0.25, source="host_clock")],
        per_layer=per_layer)))
    return spec.load_cell("tiny.mix", tmp_path)


def _run(cell, seconds=0.6, trace=False, seed=7):
    return run.run_cell(cell, seed, seconds, trace, "cpu")


def test_throwaway_cell_runs_by_name(tmp_path):
    cell = _tiny(tmp_path)
    assert [m["name"] for m in cell.per_layer] == ["steps_in_window"]
    out = _run(cell)
    assert out["correct"], out
    assert set(out["metrics"]) == {"realtime_streams", "setup_s"}
    assert out["metrics"]["realtime_streams"]["value"] > 0
    assert list(out)[-1] == "checks"
    assert out["failed"] == 0 and out["attempted"] > 0
    # the per-layer side (no device trace on the CPU): the throwaway
    # metric is read from its own file
    out = _run(cell, seconds=0.3, trace=True)
    assert set(out["metrics"]) == {"steps_in_window"}
    # the window ends on a whole K-frame window (K 2 here)
    steps = out["metrics"]["steps_in_window"]["value"]
    assert steps >= 2 and steps % 2 == 0
    assert out["metrics"]["steps_in_window"]["unit"] == "steps"


def test_generator_is_deterministic_per_seed():
    cell = spec.load_cell("music_celt_fb_stereo.offline_k64", ROOT)
    c0 = generator.plan(cell.config, cell.traffic, 99, 10, ROOT)
    for seed in (0, 1386869985, 2**31 + 17, 2**40 + 3, -5):
        a = generator.plan(cell.config, cell.traffic, seed, 10, ROOT)
        b = generator.plan(cell.config, cell.traffic, seed, 10, ROOT)
        assert (a.src == b.src).all() and (a.start == b.start).all()
        assert a.compare == b.compare and a.length == b.length
        # every seed: the same streams, dealt to the rows in another order
        assert np.bincount(a.src).tolist() == [1024, 1024]
        assert sorted(zip(a.src, a.start)) == sorted(zip(c0.src, c0.start))
    c = generator.plan(cell.config, cell.traffic, 1, 10, ROOT)
    assert not (a.start == c.start).all()
    lossy = dict(cell.traffic, loss=dict(rate=0.1, mean_burst=2.5,
                                         fec=True))
    x = generator.plan(cell.config, lossy, 3, 10, ROOT)
    y = generator.plan(cell.config, lossy, 3, 10, ROOT)
    assert (x.lost == y.lost).all()
    assert 0.07 < x.lost.mean() < 0.13


def test_comparison_fails_on_one_lsb():
    rng = np.random.default_rng(0)
    want = [rng.integers(-3000, 3000, (960 * 5 - 312, 2)).astype(np.int16)
            for _ in range(3)]
    got = [w.copy() for w in want]
    assert compare.correct(compare.compare(got, want)["values"])
    got[1][960 * 2 + 17, 1] += 1
    res = compare.compare(got, want)
    assert res["values"]["pcm_max_abs_diff"] == 1 and res["failed"] == 1
    assert not compare.correct(res["values"])
    got = [w.copy() for w in want]
    got[2] = got[2][:-960]
    res = compare.compare(got, want)
    assert res["values"]["frames_missing"] == 1
    assert not compare.correct(res["values"])


def _fault_state_unchanged(monkeypatch):
    from esp32_opus_player_tpu_torch.models import stream_pool as sp
    orig = sp._CeltLane.run

    def run_(self, stgK, masked, aux=None):
        keep = {k: v.clone() for k, v in self.state.items()}
        pcm = orig(self, stgK, masked, aux)
        for k, v in keep.items():
            self.state[k].copy_(v)
        return pcm
    monkeypatch.setattr(sp._CeltLane, "run", run_)


def _fault_half_left_out(monkeypatch):
    from esp32_opus_player_tpu_torch.models import stream_pool as sp
    orig = sp.StreamPool._route

    def route(self, parts):
        for p in parts:
            if p["lane"] is not None:
                p["sel"] = p["sel"][p["sel"] % 2 == 0]
        return orig(self, parts)
    monkeypatch.setattr(sp.StreamPool, "_route", route)


def _fault_answer_altered(monkeypatch):
    from esp32_opus_player_tpu_torch.models import stream_pool as sp
    calls = []
    for lane in (sp._CeltLane, sp._HybridLane):
        def frames(self, frame, sel, orig=lane.frames):
            blk = orig(self, frame, sel)
            calls.append(1)
            if len(calls) == 3:
                blk = blk.copy()
                blk[0, 100, 0] += 1
            return blk
        monkeypatch.setattr(lane, "frames", frames)


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("fault", [_fault_state_unchanged,
                                   _fault_half_left_out,
                                   _fault_answer_altered])
def test_fault_makes_run_incorrect(tmp_path, monkeypatch, fault, config):
    """Each fault a cell can have, planted under a run of a tiny cell of
    each configuration (a hybrid lane's CELT half is a _CeltLane, so the
    state fault reaches it too). One card, no exchange between chips:
    that fault has no place here."""
    cell = _tiny(tmp_path, extra_metric=False, config=config)
    fault(monkeypatch)
    out = _run(cell, seconds=0.3)
    assert not out["correct"], out["checks"]


def test_control_is_not_correct():
    src = generator.oggopus.parse((ROOT / CELT).read_bytes())
    task = dict(packets=list(src.packets[:12]), discard=[312], channels=2,
                compat=True, lost=None, fec=False)
    want = compare.decode_stream(task)
    got = compare.decode_stream(dict(task, control=True))
    res = compare.compare([got], [want])
    assert not compare.correct(res["values"])
    assert 0 < res["values"]["pcm_max_abs_diff"] < 100


@pytest.mark.parametrize("name,channels", [
    ("celt_fb_stereo_20ms", 2), ("celt_fb_stereo_drums_20ms", 2),
    ("hybrid_swb_mono_20ms", 2), ("hybrid_swb_fec_mono_20ms", 2)])
def test_reference_equals_golden(name, channels):
    src = generator.oggopus.parse(
        (BENCH / "fixtures" / f"{name}.opus").read_bytes())
    n = 25
    pcm = compare.decode_stream(dict(packets=list(src.packets[:n]),
                                     discard=[src.pre_skip],
                                     channels=channels, compat=True))
    gold = np.fromfile(ROOT / "tests" / "golden" / f"{name}.pcm",
                       dtype=np.int16).reshape(-1, channels)
    assert np.array_equal(pcm, gold[:len(pcm)])


def _imports(path: pathlib.Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module)
    return out


def test_no_jax_in_harness_or_reference():
    bad = {"jax", "jaxlib", "flax", "esp32_opus_player_tpu"}
    for p in BENCH.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(p)}
        assert not tops & bad, (p, tops & bad)
        if "reference" in p.relative_to(BENCH).parts:
            assert "esp32_opus_player_tpu_torch" not in tops, p
            assert "torch" not in tops, p
    code = ("import sys, bench_port.run, bench_port.control, "
            "bench_port.reference.models.opus_decoder as o; "
            "o.OpusDecoder(2); "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    mods = json.loads(subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, check=True).stdout.replace("'", '"'))
    assert not set(mods) & bad
    assert "esp32_opus_player_tpu_torch" not in mods


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_to_the_contract():
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51 and b["paths"] == ["bench_port"]
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("bench_port/")
        assert (ROOT / c["file"]).is_file() and c["reduced"] == []
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] == 1
        assert len(w["why"]) <= 200
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        spec.metric_reader([BENCH], m["name"])
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    for w in b["workloads"]:
        cell = spec.load_cell(w["name"], ROOT)
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
        assert all(m["moves"] in e2e for m in cell.per_layer)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.cuda
def test_tiny_cell_on_the_card(tmp_path, card):
    cell = _tiny(tmp_path, streams=64)
    out = run.run_cell(cell, 11, 1.0, True, card)
    assert out["correct"], out["checks"]
    assert out["device"]["busy_s"] > 0
