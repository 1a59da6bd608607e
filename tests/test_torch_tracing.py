"""The port's spans and counters (``utils/time_report.py``) and the
benchmark's arithmetic on them (``benchmark/harness/spans.py``), on the
CPU.

- Off: with no profiler active nothing is recorded, ``span()`` returns the
  shared no-op and ``count()`` does nothing.
- Tree: one tiny SHAC epoch and one tiny PPO epoch on CartPole (4 envs,
  3 steps), each writing a new best policy, under
  ``torch.profiler.profile`` record the trainers' span trees with the
  right parents and epochs; every span's K1 and K2 launches read 0 (the
  CPU runs the plain path; the card's counts are checked on the card).
- Threads: a span opened on a thread with no open span takes as parent
  the span open where the thread's work was handed over (on the card
  autograd runs ``sim.replay`` on its device thread; on the CPU backward
  runs on the calling thread, so the epochs cannot show it), and counts
  go to the innermost span of the counting thread; eight threads
  switching every microsecond each keep their own tree and counts.
- Clock: the profiler's events of an op run inside a span lie within the
  span's stamps.
- Arithmetic: the epoch's spans (its statistics' root kept after the
  card's last operation, an earlier epoch's root left out), self time,
  the idle gaps' attribution and the epoch's syncs less a checkpoint
  write's on a synthetic trace with known answers.
- Export: ``profiling.trace()``'s Chrome trace, larger than the head the
  exporter reads, carries the spans as one more track, each op within
  its span; the span track lands on the trace's time base whether the
  trace names it before its events or after them.
- Syncs (``cuda``-marked, on the card: ``python -m pytest --noconftest -m
  cuda tests/test_torch_tracing.py``): torch's sync detector, on inside a
  root span, counts each host read against the innermost span of the
  thread that made it, autograd's device thread included, and is off
  again after the span.
"""

import json
import os
import sys
import threading

import numpy as np
import pytest
import torch
import yaml
from torch.profiler import ProfilerActivity, profile

from diffrl_tpu_torch.algorithms import PPO, SHAC
from diffrl_tpu_torch.utils import profiling
from diffrl_tpu_torch.utils import time_report as tr

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from benchmark.harness import spans as bench_spans  # noqa: E402
from benchmark.harness.trace import Trace  # noqa: E402

torch.set_num_threads(1)  # the suite's pytest workers share a few cores

HERE = os.path.dirname(__file__)


def _recorded(fn):
    """The spans recorded while ``fn`` runs under a CPU profiler."""
    tr.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        fn()
    return tr.spans()


class _Trainer:
    """What ``epoch_span`` reads of a trainer."""

    def __init__(self, iter_count):
        self.iter_count = iter_count

    def run(self, fn):
        return fn()


def _root(name, iter_count):
    """A function that runs ``fn`` inside the root span ``name`` of a
    trainer at ``iter_count``."""
    method = tr.epoch_span(name)(_Trainer.run)
    return lambda fn: method(_Trainer(iter_count), fn)


def _tree(recs):
    by_id = {s.id: s for s in recs}
    return {(s.name, by_id[s.parent].name if s.parent else None)
            for s in recs}


def _cfg(algo, logdir, **config):
    with open(os.path.join(HERE, "..", "examples", "cfg", algo,
                           "cartpole_swing_up.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["params"]["general"] = {"logdir": str(logdir), "seed": 0}
    cfg["params"]["config"].update(num_actors=4, steps_num=3, **config)
    return cfg


def _epoch(trainer):
    """One epoch, its statistics finding a new best policy to write."""
    trainer.start_time = trainer._t_last_epoch = 0.0
    trainer._best_snapshot, trainer._last_best_write = None, 0.0
    if isinstance(trainer, SHAC):
        trainer.best_policy_loss = np.inf
        trainer.episode_loss_his.append(0.0)
    else:
        trainer.best_rew = -np.inf
        trainer.episode_rew_meter.update(np.zeros(1))
    for t in ("algorithm", "actor training"):
        if t not in trainer.time_report.timers:
            trainer.time_report.add_timer(t)
    trainer._process_epoch_stats(trainer.train_epoch())


def test_off_records_nothing():
    tr.clear()
    assert tr.span("sim.refresh") is tr.span("env.step")

    @tr.traced("nets.forward")
    def f(x):
        return x + 1

    with tr.span("sim.refresh") as s:
        assert s is None
        tr.count("host.syncs")
        assert f(1) == 2
    assert tr.spans() == []


SHAC_TREE = {
    ("shac.epoch", None), ("shac.stats", None),
    ("trainer.save", "shac.stats"),
    ("shac.rollout", "shac.epoch"), ("shac.actor_step", "shac.epoch"),
    ("shac.critic_step", "shac.epoch"),
    ("nets.forward", "shac.rollout"), ("env.step", "shac.rollout"),
    ("sim.simulate", "env.step"), ("sim.refresh", "sim.simulate"),
    ("sim.cached", "sim.simulate"),
    ("shac.backward", "shac.actor_step"), ("optim.step", "shac.actor_step"),
    ("sim.replay", "shac.backward"), ("sim.vjp", "sim.replay"),
    ("sim.replay_refresh", "sim.replay"),
    ("shac.targets", "shac.critic_step"),
    ("shac.critic_update", "shac.critic_step"),
    ("nets.forward", "shac.critic_update"),
    ("optim.step", "shac.critic_update"),
}
PPO_TREE = {
    ("ppo.epoch", None), ("ppo.stats", None),
    ("trainer.save", "ppo.stats"),
    ("ppo.play_steps", "ppo.epoch"), ("ppo.update", "ppo.epoch"),
    ("nets.forward", "ppo.play_steps"), ("env.step", "ppo.play_steps"),
    ("sim.simulate", "env.step"), ("sim.refresh", "sim.simulate"),
    ("sim.cached", "sim.simulate"),
    ("ppo.returns", "ppo.update"), ("nets.forward", "ppo.update"),
    ("optim.step", "ppo.update"),
}


@pytest.mark.parametrize("algo", ["shac", "ppo"])
def test_a_tiny_epoch_records_its_span_tree(algo, tmp_path):
    if algo == "shac":
        trainer = SHAC(_cfg("shac", tmp_path, critic_iterations=2,
                            num_batch=2, save_interval=0), device="cpu")
        want = SHAC_TREE
    else:
        trainer = PPO(_cfg("ppo", tmp_path, minibatch_size=6,
                           mini_epochs=2, save_frequency=0), device="cpu")
        want = PPO_TREE
    trainer.iter_count = 5
    recs = _recorded(lambda: _epoch(trainer))
    assert _tree(recs) == want
    names = [s.name for s in recs]
    assert names.count("env.step") == names.count("sim.simulate") == 3
    assert names.count("sim.refresh") == names.count("sim.cached") == 3
    assert names.count("sim.replay") == (3 if algo == "shac" else 0)
    assert {s.epoch for s in recs} == {5} and trainer.iter_count == 6
    assert {s.thread for s in recs} == {threading.get_ident()}
    for s in recs:
        assert s.counts["k1.launches"] == s.counts["k2.launches"] == 0
        assert s.start_ns <= s.end_ns
    by_id = {s.id: s for s in recs}
    for s in recs:
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    n = len(tr.spans())
    _epoch(trainer)                     # no profiler: nothing recorded
    assert len(tr.spans()) == n


def test_a_thread_without_spans_takes_the_handing_over_span():
    out = {}

    def work():
        with tr.span("worker") as s:
            out["worker"] = s
            tr.count("host.syncs")
        for _ in range(2):              # no open span: the handover's
            tr.count("host.syncs")

    def run():
        with tr.span("handover") as h:
            out["handover"] = h
            t = threading.Thread(target=work)
            t.start()
            t.join()
        with tr.span("after"):
            for _ in range(3):
                tr.count("host.syncs")

    recs = {s.name: s for s in _recorded(lambda: _root("outer", 7)(run))}
    worker, handover = recs["worker"], recs["handover"]
    assert out["worker"] is worker and out["handover"] is handover
    assert worker.parent == handover.id
    assert worker.thread != handover.thread
    assert worker.epoch == handover.epoch == 7
    assert worker.counts["host.syncs"] == 1
    assert handover.counts["host.syncs"] == 2
    assert recs["after"].counts["host.syncs"] == 3
    assert "host.syncs" not in recs["outer"].counts
    assert recs["after"].parent == recs["outer"].id


def test_threads_record_their_own_trees_under_contention():
    interval = sys.getswitchinterval()

    def work(i):
        for _ in range(100):
            with tr.span(f"w{i}"):
                with tr.span(f"w{i}.inner"):
                    tr.count("host.syncs")
                tr.count("host.syncs")

    def run():
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)

    sys.setswitchinterval(1e-6)
    try:
        recs = _recorded(lambda: _root("root", 0)(run))
    finally:
        sys.setswitchinterval(interval)
    by_id = {s.id: s for s in recs}
    for i in range(8):
        outer = [s for s in recs if s.name == f"w{i}"]
        inner = [s for s in recs if s.name == f"w{i}.inner"]
        assert len(outer) == len(inner) == 100
        assert all(s.counts["host.syncs"] == 1 for s in outer + inner)
        assert all(by_id[s.parent].name == f"w{i}" for s in inner)
        assert len({s.thread for s in outer + inner}) == 1
    assert "host.syncs" not in by_id[min(by_id)].counts


def test_profiler_events_lie_within_their_span():
    x = torch.ones(4096)

    def run():
        for _ in range(50):
            with tr.span("clock"):
                x.add(1.0)

    tr.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    spans = sorted((s for s in tr.spans() if s.name == "clock"),
                   key=lambda s: s.start_ns)
    events = sorted((e for e in prof.profiler.kineto_results.events()
                     if e.name() == "aten::add"), key=lambda e: e.start_ns())
    assert len(spans) == len(events) == 50
    for s, e in zip(spans, events):
        assert s.start_ns <= e.start_ns()
        assert e.start_ns() + e.duration_ns() <= s.end_ns


def _rec(id_, name, a, b, parent=None, thread=1, epoch=None):
    return bench_spans.Rec(id_, name, a, b, parent, thread, (), epoch)


def test_self_time_and_idle_attribution():
    recs = [
        _rec(1, "shac.epoch", 0.9, 2.2, epoch=3),
        _rec(2, "env.step", 1.0, 1.5, 1),
        _rec(3, "sim.simulate", 1.15, 1.45, 2),
        _rec(4, "sim.replay", 1.6, 2.1, 1, thread=2),   # another thread
        _rec(5, "shac.stats", 2.6, 2.8, epoch=3),      # after the card's work
    ]
    trace = Trace(window_s=1.9, device=[
        (1.0, 1.1, "k"), (1.3, 1.4, "k"), (2.0, 2.05, "k"),
        (2.25, 2.3, "k"), (2.5, 2.55, "k")])
    earlier = _rec(6, "shac.epoch", 0.1, 0.5, epoch=2)
    assert bench_spans.select_epoch(trace, [earlier] + recs) == recs
    assert bench_spans.self_ms(recs, "env.step") == pytest.approx(200.0)
    assert bench_spans.total_ms(recs, "sim.replay") == pytest.approx(500.0)
    assert bench_spans.total_ms(recs, "sim.refresh") is None
    gaps = bench_spans.idle_gaps(trace, recs)
    assert gaps == pytest.approx([(0.9, 1.0), (1.1, 1.3), (1.4, 2.0),
                                  (2.05, 2.25), (2.3, 2.5), (2.55, 2.8)])
    idle = bench_spans.idle_by_span(trace, recs)
    # midpoints 0.95 epoch, 1.2 sim.simulate, 1.7 sim.replay (thread 2,
    # the latest started), 2.15 epoch, 2.4 none, 2.675 stats
    want = {"shac.epoch": 0.3, "sim.simulate": 0.2, "sim.replay": 0.6,
            None: 0.2, "shac.stats": 0.25}
    assert set(idle) == set(want)
    for k, v in want.items():
        assert idle[k] == pytest.approx(v)
    assert bench_spans.idle_pct(
        trace, recs, lambda n: n is not None and n.startswith("sim.")
    ) == pytest.approx(100.0 * 0.8 / 1.55)
    assert bench_spans.idle_pct(
        trace, recs, lambda n: n is None) == pytest.approx(100.0 * 0.2 / 1.55)
    # the epoch's syncs less those in or under a checkpoint write
    counted = [
        bench_spans.Rec(1, "shac.stats", 0.0, 1.0, None, 1,
                        (("host.syncs", 1),)),
        bench_spans.Rec(2, "trainer.save", 0.2, 0.8, 1, 1,
                        (("host.syncs", 88),)),
        bench_spans.Rec(3, "inner", 0.3, 0.4, 2, 2, (("host.syncs", 5),)),
        bench_spans.Rec(4, "shac.epoch", 1.0, 2.0, None, 1,
                        (("host.syncs", 2),)),
    ]
    assert bench_spans.syncs(counted) == 3


def test_the_chrome_trace_carries_the_spans(tmp_path):
    x = torch.ones(8)
    tr.clear()
    with profiling.trace(str(tmp_path), device="cpu"):
        for _ in range(2000):           # a trace longer than the head read
            x.add(1.0)
        _root("outer", 2)(lambda: _inner(x))
    (path,) = tmp_path.glob("*.trace.json")
    assert path.stat().st_size > profiling._PEEK
    events = profiling.load_trace(str(tmp_path))
    track = [e for e in events if e.get("pid") == profiling.SPAN_TRACK
             and e.get("ph") == "X"]
    assert sorted(e["name"] for e in track) == ["inner", "outer"]
    by = {e["name"]: e for e in track}
    assert by["inner"]["args"]["parent"] == by["outer"]["args"]["id"]
    assert by["inner"]["args"]["epoch"] == 2
    mul = [e for e in events if e.get("name") == "aten::mul"]
    assert len(mul) == 1
    a = by["inner"]
    assert a["ts"] <= mul[0]["ts"]
    assert mul[0]["ts"] + mul[0]["dur"] <= a["ts"] + a["dur"] + 1e-3


def _inner(x):
    with tr.span("inner"):
        x.mul(3.0)


@pytest.mark.parametrize("layout", ["head", "trailer"])
def test_the_span_track_lands_on_the_trace_time_base(layout, tmp_path):
    base = 1_790_857_026_000_000_000
    ops = [{"ph": "X", "cat": "cpu_op", "name": f"op{i}", "pid": 1,
            "tid": 1, "ts": 10.0 + i, "dur": 0.5} for i in range(20000)]
    trace = {"schemaVersion": 1, "traceEvents": ops}
    if layout == "head":
        trace = {"baseTimeNanoseconds": base, **trace}
    else:
        trace["baseTimeNanoseconds"] = base
    path = tmp_path / "1.trace.json"
    path.write_text(json.dumps(trace, indent=1))
    assert path.stat().st_size > 2 * profiling._PEEK
    span = tr.Span("window", None, 1, 3)
    span.start_ns, span.end_ns = base + 5_000, base + 20_005_000
    profiling._add_spans(str(path), [span])
    events = profiling.load_trace(str(tmp_path))
    (track,) = [e for e in events if e.get("pid") == profiling.SPAN_TRACK
                and e.get("ph") == "X"]
    assert track["ts"] == pytest.approx(5.0)
    assert track["dur"] == pytest.approx(20000.0)
    assert [e for e in events if e.get("cat") == "cpu_op"] == ops


@pytest.mark.cuda
def test_host_syncs_are_counted_where_they_happen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")

    class Read(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return 2.0 * x

        @staticmethod
        def backward(ctx, g):
            with tr.span("reader"):
                g.sum().item()
            return 2.0 * g

    x = torch.ones(1000, device="cuda", requires_grad=True)
    mode = torch.cuda.get_sync_debug_mode()

    def run():
        with tr.span("reads"):
            x.sum().item()
            x.detach().cpu()
            (x > 0).nonzero()
        with tr.span("backward"):
            Read.apply(x).sum().backward()
        with tr.span("quiet"):
            (3.0 * x).sum()

    recs = {s.name: s for s in _recorded(lambda: _root("root", 0)(run))}
    assert recs["reads"].counts["host.syncs"] == 3
    assert recs["reader"].counts["host.syncs"] == 1
    assert recs["reader"].thread != recs["reads"].thread
    assert recs["reader"].parent == recs["backward"].id
    assert "host.syncs" not in recs["quiet"].counts
    assert torch.cuda.get_sync_debug_mode() == mode
