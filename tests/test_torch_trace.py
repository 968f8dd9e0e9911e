"""The port's tracer (``gs_init_tpu_torch/trace.py``) on the CPU: off, it
makes no annotation, event or counter; on, its spans nest with parents,
self times and the step they belong to, its counters add on the host and
on the tensors' device, its memory stays bounded, and spans from many
threads add up. A tiny Runner with ``--trace`` writes ``stats/trace.json``
with the spans and counters its path reaches; a ``torch.profiler`` trace of
a traced step holds the spans as user annotations; a traced step leaves the
same state, to the bit, as an untraced one.
"""
import json
import os
import sys
import threading
import time

import pytest
import torch

from gs_init_tpu_torch import trace, trainer
from gs_init_tpu_torch.datasets.synthetic import make_scene, write_colmap_scene
from gs_init_tpu_torch.engine.params import num_alive
from gs_init_tpu_torch.engine.runner import Runner
from gs_init_tpu_torch.engine.strategy import default as pdefault
from gs_init_tpu_torch.engine.train_step import STEP_PHASES

torch.set_num_threads(2)


@pytest.fixture
def tracer():
    """The tracer on the CPU with nothing recorded; off again afterwards."""
    trace.enable("cpu")
    trace.reset()
    try:
        yield trace
    finally:
        trace.disable()
        trace.reset()


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    sc = make_scene(n_gaussians=64, n_cams=8, width=64, height=48, device="cpu")
    return write_colmap_scene(str(tmp_path_factory.mktemp("trace")), sc, n_points=48)


def _runner(scene_dir, result_dir, preset="default"):
    """A tiny Runner in the loop, no prefetch thread; refines (or
    relocations) at steps 2 and 4."""
    cfg = trainer.build_presets()[preset]
    cfg.data_dir, cfg.data_factor, cfg.result_dir, cfg.test_every = scene_dir, 1, result_dir, 4
    cfg.max_gaussians, cfg.tile_size, cfg.sh_degree = 128, 16, 1
    cfg.eval_steps, cfg.save_steps, cfg.mesh, cfg.data_prefetch = [], [], "off", 0
    cfg.strategy.refine_start_iter, cfg.strategy.refine_every = 0, 2
    if preset == "default":
        cfg.strategy.grow_grad2d = 1e-12  # every visible gaussian is a candidate
    return Runner(cfg, device="cpu")


def test_off_makes_no_annotation_event_or_counter(monkeypatch, scene_dir, tmp_path):
    """Off: ``span`` is one shared no-op, ``phases`` hands back the caller's
    mark, the counters keep nothing, and whole train iterations (the step's
    phases, the refine) under a profiler enter no ``record_function`` and
    make no event."""
    trace.enable("cpu")
    trace.reset()
    trace.disable()
    made = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda *a, **k: made.append(("rf", a)))
    monkeypatch.setattr(torch.cuda, "Event", lambda *a, **k: made.append(("event", a)))
    assert trace.span("a") is trace.span("b") is trace._NOOP
    with trace.span("a"):
        pass
    marks = []
    mark = marks.append
    assert trace.phases(STEP_PHASES, mark) is mark
    trace.phases(STEP_PHASES)("setup")  # no mark given: a no-op
    trace.set_step(3)
    trace.count("c")
    trace.count_device("d", torch.ones((), dtype=torch.int64))
    r = _runner(scene_dir, str(tmp_path))
    # Under a profiler, where a span that is on enters record_function.
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for step in range(3):  # a refine at step 2
            r.train_iteration(step)
    assert not made and not marks
    rep = trace.report()
    assert rep["spans"] == {} and rep["counters"] == {}
    assert not trace._tracer.acc and not trace.records()


def test_spans_nest_with_parents_self_time_and_the_step(tracer):
    trace.set_step(7)
    with trace.span("outer"):
        time.sleep(0.02)
        with trace.span("inner"):
            time.sleep(0.03)
        with trace.span("inner"):
            time.sleep(0.01)
    trace.set_step(8)
    with trace.span("inner"):
        pass
    spans = trace.report()["spans"]
    o, i = spans["outer"], spans["inner"]
    assert o["n"] == 1 and i["n"] == 3
    assert o["host_ms"] >= 60 and i["host_ms"] >= 40
    records = trace.records()
    inner_7 = sum(r["host_ms"] for r in records if r["name"] == "inner" and r["item"] == 7)
    assert o["self_host_ms"] == pytest.approx(o["host_ms"] - inner_7, abs=1e-5)
    assert i["self_host_ms"] == i["host_ms"]
    assert o["device_ms"] is None and o["median_device_ms"] is None  # no device clock on the CPU
    assert o["median_host_ms"] == o["host_ms"]
    assert [(r["name"], r["parent"], r["item"]) for r in records] == [
        ("inner", "outer", 7), ("inner", "outer", 7), ("outer", None, 7), ("inner", None, 8)]


def test_phases_follow_each_other_and_call_the_mark(tracer):
    marks = []
    boundary = trace.phases(STEP_PHASES, marks.append)
    with pytest.raises(ValueError):
        boundary("render")  # the setup phase runs
    for name in STEP_PHASES:
        boundary(name)
    assert marks == list(STEP_PHASES)
    assert [r["name"] for r in trace.records()] == list(STEP_PHASES.values())


def test_counters_add_on_the_host_and_on_the_device(tracer):
    trace.count("a")
    trace.count("a", 4)
    for v in (3, 5):
        trace.count_device("b", torch.tensor(v, dtype=torch.int32))
    trace.count_device("c", torch.tensor(0.25))
    trace.count_device("c", torch.tensor(0.5))
    trace.count("b", 2)
    rep = trace.report()
    assert rep["counters"] == {"a": 5, "b": 10, "c": 0.75}
    assert set(rep["launches"]) == {
        "composite_fwd", "composite_bwd", "scan_probe", "project_pack_fwd", "project_pack_bwd",
    }
    trace.reset()
    assert trace.report()["counters"] == {}


def test_memory_stays_bounded_over_10000_spans(tracer):
    one = torch.ones((), dtype=torch.int32)
    for i in range(10_000):
        trace.set_step(i)
        with trace.span("s"):
            with trace.span("s.inner"):
                trace.count_device("k", one)
    t = trace._tracer
    assert len(t.acc["k"][1]) < trace.FOLD and trace.report()["counters"]["k"] == 10_000
    assert t.stats["s"].n == t.stats["s.inner"].n == 10_000
    assert len(t.stats["s"].host_sample) == len(t.stats["s.inner"].host_sample) == trace.SAMPLE
    records = trace.records()
    assert len(records) == trace.SAMPLE and records[-1]["item"] == 9_999
    assert not t.pending and not t.stack()


def test_spans_and_counts_from_many_threads_add_up(tracer):
    n_threads, n_spans = 16, 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n_spans):
                with trace.span("t"):
                    with trace.span("t.inner"):
                        trace.count("n")

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    rep = trace.report()
    assert rep["spans"]["t"]["n"] == rep["spans"]["t.inner"]["n"] == n_threads * n_spans
    assert rep["counters"]["n"] == n_threads * n_spans
    assert all(r["parent"] == "t" for r in trace.records() if r["name"] == "t.inner")


WANT = {
    "both": (
        {"runner.setup", "runner.init_gaussians", "runner.iteration", "runner.data", "runner.retune",
         "runner.log", "train_step", *STEP_PHASES.values(), "datasets.load",
         "init", "init.predict", "init.align_unproject", "init.postprocess"},
        {"runner.retunes", "tiles.pairs", "tiles.overflow", "datasets.decoded", "datasets.cache_hits"},
    ),
    "default": ({"strategy.refine", "strategy.reset_opacities"}, {"strategy.grown", "strategy.pruned"}),
    "mcmc": ({"strategy.relocate", "strategy.noise"}, {"strategy.relocated"}),
}


@pytest.mark.parametrize("preset", ["default", "mcmc"])
def test_runner_with_trace_writes_its_report(preset, scene_dir, tmp_path):
    """``--trace`` through the trainer: the monocular-depth init (stub
    predictor), a retune of an oversized pair table, the prefetch thread,
    refines and an opacity reset (default) or relocations and noise (mcmc),
    logged steps; ``stats/trace.json`` holds every span and counter of the
    path and, under ``recent``, the spans of each step with their parents,
    ``train_final.json`` no longer a ``step_time``."""
    res = str(tmp_path / preset)
    argv = [preset, f"--data_dir={scene_dir}", f"--result_dir={res}", "--data_factor=1", "--test_every=4",
            "--max_steps=9", "--eval_steps=[]", "--save_steps=[]", "--tb_every=4", "--max_gaussians=128",
            "--tile_size=16", "--sh_degree=1", "--pair_capacity=262144", "--init_type=monocular_depth",
            "--mdi.predictor=stub", "--strategy.refine_start_iter=2", "--strategy.refine_every=4", "--trace"]
    if preset == "default":
        argv.append("--strategy.reset_every=6")
    trainer.main(argv, device="cpu")
    assert not trace.enabled()
    with open(os.path.join(res, "stats", "trace.json")) as f:
        rep = json.load(f)
    spans, counters = WANT["both"][0] | WANT[preset][0], WANT["both"][1] | WANT[preset][1]
    assert spans <= set(rep["spans"]), spans - set(rep["spans"])
    assert counters <= set(rep["counters"]), counters - set(rep["counters"])
    assert rep["spans"]["train_step"]["n"] == rep["spans"]["runner.iteration"]["n"] == 9
    assert rep["spans"]["runner.setup"]["n"] == rep["spans"]["init"]["n"] == 1
    assert rep["counters"]["runner.retunes"] >= 1 and rep["spans"]["init.predict"]["n"] == 6
    assert rep["counters"]["datasets.cache_hits"] > 0
    recent = rep["recent"]
    assert {r["item"] for r in recent if r["name"] == "train_step"} == set(range(9))
    assert {r["parent"] for r in recent if r["name"] == "train_step"} == {"runner.iteration"}
    phases = {(r["name"], r["item"]) for r in recent if r["parent"] == "train_step"}
    assert {(p, step) for p in STEP_PHASES.values() for step in range(9)} <= phases
    with open(os.path.join(res, "stats", "train_final.json")) as f:
        final = json.load(f)
    assert "data_time" in final and "step_time" not in final


def test_init_pipeline_path_has_its_spans(tracer, scene_dir, tmp_path):
    """SLIC regions: the init's align, unproject, segment and merge spans,
    one of each an image, inside ``init``."""
    from gs_init_tpu_torch.datasets.parser import Parser
    from gs_init_tpu_torch.mdi.init import pts_and_rgb_from_monocular_depth
    from gs_init_tpu_torch.mdi.predictors.stub import StubPredictor

    cfg = trainer.build_presets()["default"]
    cfg.data_dir, cfg.result_dir = scene_dir, str(tmp_path)
    cfg.mdi.alignment.segmentation.method = "slic"
    cfg.mdi.alignment.segmentation.slic_n_segments = 4
    parser = Parser(scene_dir, factor=1, test_every=4)
    per_image = []
    pts_and_rgb_from_monocular_depth(cfg, parser, model=StubPredictor(), device="cpu", per_image=per_image)
    rep = trace.report()
    n = len(parser.split_indices("train"))
    assert n == 6
    for name in ("init.predict", "init.segment", "init.merge", "init.align"):
        assert rep["spans"][name]["n"] == n, name
    assert rep["spans"]["init.unproject"]["n"] == len(per_image) > 0
    parents = {r["name"]: r["parent"] for r in trace.records()}
    assert parents["init.segment"] == parents["init.merge"] == "init.align"
    assert parents["init.align"] == parents["init.predict"] == "init"


def test_profiler_trace_holds_the_spans(tracer, scene_dir, tmp_path, monkeypatch):
    """Under a profiler each span is a user annotation; outside one no
    ``record_function`` is entered."""
    r = _runner(scene_dir, str(tmp_path))
    real, entered = torch.profiler.record_function, []
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: entered.append(name) or real(name))
    r.train_iteration(1)
    assert not entered
    trace.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        r.train_iteration(0)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert names <= set(entered)
    want = {"runner.iteration", "runner.data", "runner.retune", "train_step", *STEP_PHASES.values()}
    assert want <= names, want - names
    assert {r["item"] for r in trace.records() if r["name"] in want} == {0}


@pytest.mark.parametrize("preset", ["default", "mcmc"])
def test_traced_steps_leave_the_untraced_state(preset, scene_dir, tmp_path):
    """Three steps (a refine or relocation at step 2) with the tracer off and
    on, from the same start: equal state and metrics, to the bit."""
    out = []
    for on in (False, True):
        trace.enable("cpu") if on else trace.disable()
        trace.reset()
        try:
            r = _runner(scene_dir, str(tmp_path / str(on)), preset)
            metrics = [r.train_iteration(step) for step in range(3)]
        finally:
            trace.disable()
        state = dict(alive=r.gstate.alive, **{"p." + k: v for k, v in r.gstate.params.items()},
                     **{"mu." + k: v for k, v in r.adam.mu.items()}, **{"nu." + k: v for k, v in r.adam.nu.items()},
                     **{"s." + k: getattr(r.sstate, k) for k in ("grad2d", "count", "radii_max")})
        out.append((state, metrics))
    (s0, m0), (s1, m1) = out
    assert s0.keys() == s1.keys()
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k
    for a, b in zip(m0, m1):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert trace.report()["spans"]["train_step"]["n"] == 3


def test_refine_counts_stay_on_the_device(tracer, scene_dir, tmp_path):
    """The refine's statistics are 0-d tensors (no host read per refine);
    the tracer's ``strategy.grown`` less ``strategy.pruned`` is the change
    in alive gaussians."""
    r = _runner(scene_dir, str(tmp_path))
    for step in range(2):
        r.train_iteration(step)
    before = num_alive(r.gstate)
    trace.reset()
    eps1, eps2 = pdefault.split_noise(r.cfg.max_gaussians, r.gen)
    g, _, _, stats = pdefault.refine(r.gstate, r.adam, r.sstate, eps1, eps2, r.scene_scale, r.cfg.strategy, 2)
    assert set(stats) == {"n_dup", "n_split", "n_pruned"}
    assert all(isinstance(v, torch.Tensor) and v.dim() == 0 for v in stats.values())
    c = trace.report()["counters"]
    assert c["strategy.grown"] > 0
    assert num_alive(g) - before == c["strategy.grown"] - c["strategy.pruned"]
    assert trace.report()["spans"]["strategy.refine"]["n"] == 1

