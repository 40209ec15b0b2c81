"""What the port emits on the observability stack, against ray_tpu's.

The port now has its own copy of the observability layer (the event bus,
tracing, the metrics registry), so the two callers that waited for it
emit what JAX's do: ``rllib/podracer/obs.py::StageTimes`` (a tracing
span per stage, a sample of the ``ray_tpu_podracer_stage_seconds``
histogram and a ``podracer_stage`` event) and ``train.session.report()``
(a ``train.step`` span per step after the first). Each package runs the
same calls with tracing on; the records must agree in kind, name, fields
and attributes, times and random ids aside.
"""

import pytest

import ray_tpu.observability
import ray_tpu.rllib.podracer.obs
import ray_tpu.train.session
import ray_tpu.util.metrics
import ray_tpu_torch.observability
import ray_tpu_torch.rllib.podracer.obs
import ray_tpu_torch.train.session
import ray_tpu_torch.util.metrics

PACKAGES = {
    "jax": (ray_tpu.observability, ray_tpu.rllib.podracer.obs, ray_tpu.train.session,
            ray_tpu.util.metrics),
    "port": (ray_tpu_torch.observability, ray_tpu_torch.rllib.podracer.obs,
             ray_tpu_torch.train.session, ray_tpu_torch.util.metrics),
}
TIMES_AND_IDS = {"ts", "dur", "trace_id", "span_id", "parent_span_id", "worker", "job_id"}


def shape(ev):
    """An event with its times and ids reduced to their presence."""
    return {k: (type(v).__name__ if k in TIMES_AND_IDS else v) for k, v in ev.items()}


@pytest.fixture
def tracing_on():
    for obs, *_ in PACKAGES.values():
        obs.configure(enabled=True)
    yield
    for obs, *_ in PACKAGES.values():
        obs.configure(enabled=False)


def stage_records(pkg):
    obs, podracer, _, metrics = PACKAGES[pkg]
    hist = podracer._stage_histogram()
    before = len(obs.local_events())
    # the histogram is process-wide: another test in this process may have
    # recorded stages before, so what this call adds is the difference
    counted = {tuple(sorted(s["tags"].items())): s["count"]
               for s in hist._snapshot()["series"]}
    st = podracer.StageTimes()
    with st.track(podracer.STAGE_UPDATE, learner=0):
        pass
    with st.track(podracer.STAGE_UPDATE):
        pass
    with st.track(podracer.STAGE_ENV_STEP, envs=4):
        pass
    snap = st.snapshot()
    new = obs.local_events()[before:]
    spans = [shape(e) for e in new if e["type"] == "span"]
    stage = [e for e in new if e["type"] == "podracer_stage"]
    assert len(stage) == 1 and stage[0]["stages"] == snap
    counts = {key: n - counted.get(key, 0) for key, n in
              ((tuple(sorted(s["tags"].items())), s["count"])
               for s in hist._snapshot()["series"])}
    counts = {key: n for key, n in counts.items() if n}
    return (spans, {k: v["n"] for k, v in snap.items()}, sorted(shape(stage[0])),
            hist._snapshot()["name"], hist._snapshot()["type"], counts)


def test_stage_times_emit_jax_records(tracing_on):
    jax, port = stage_records("jax"), stage_records("port")
    assert port[:5] == jax[:5]
    spans = port[0]
    assert [s["name"] for s in spans] == ["podracer.update"] * 2 + ["podracer.env_step"]
    assert [s["attrs"] for s in spans] == [{"learner": 0}, {}, {"envs": 4}]
    assert all(s["kind"] == "podracer" for s in spans)
    # the histogram's samples land in each package's own registry
    assert port[5].keys() == jax[5].keys()
    assert port[5][(("stage", "podracer.update"),)] >= 2


def step_spans(pkg):
    obs, _, session, _ = PACKAGES[pkg]
    session._set_session(None)
    ctx = session.get_context()
    before = len(obs.local_events())
    try:
        with obs.span("trial", kind="tune"):
            for step in range(3):
                session.report({"loss": 1.0 / (step + 1)})
    finally:
        session._set_session(None)
    reports = []
    while not ctx._report_queue.empty():
        reports.append(ctx._report_queue.get())
    spans = [shape(e) for e in obs.local_events()[before:] if e["type"] == "span"]
    return spans, reports


def test_report_records_the_train_step_span(tracing_on):
    jax, port = step_spans("jax"), step_spans("port")
    assert port == jax
    spans, reports = port
    steps = [s for s in spans if s["name"] == "train.step"]
    assert [s["attrs"] for s in steps] == [{"step": 1, "world_rank": 0},
                                            {"step": 2, "world_rank": 0}]
    assert all(s["kind"] == "train" for s in steps)
    assert [r["metrics"]["loss"] for r in reports] == [1.0, 0.5, 1.0 / 3]
