"""The port's tracing (``utils/profiling.py``): host spans, the device
stamps inside the device loop's step, the per-chunk records they give,
the census of a captured step's graph and the operator's Chrome trace.
JAX-free, so its ``cuda`` tests run on the card.

CPU (the stamps' plain version writes the host's clock):

- every chunk of a tiny device-loop run stamps every slot of every step,
  in order, and each chunk's span self times plus its step gaps add up to
  the chunk's stamped interval;
- remat's recompute runs its spans inside ``train.backward``, and only
  under remat;
- ``host_ms`` names every ``loop.*`` span a chunk ran, surgery and bounds
  refresh included, and the boundary's unnamed rest; only a chunk with a
  logged step waits for the device;
- nested ``Spans`` keep their parent, a thread its own stack;
- ``step_times``, ``graph_kernels``, ``idle_stamps`` and ``fill_dropped``
  on hand-made stamps and graphs;
- ``trace``'s Chrome trace holds the program's spans.

On the card (``cuda``): stamps captured in a graph differ across the
replays of one chunk, and an idle stamp taken out of the graph writes
nothing; ``stamp.cu`` builds with no ptxas spill; the timer's resolution
(the least step between stamps launched back to back); and, with the
profiler on the host and the card,
every ``cudaGraphLaunch`` lies inside a ``loop.enqueue`` span and every
stamp kernel within 50 us of its stamp placed by the run's offset.
"""
import json
import threading

import numpy as np
import pytest
import torch

from bloomscene_tpu_torch.config import GSConfig
from bloomscene_tpu_torch.models.model import init_model
from bloomscene_tpu_torch.scene.cameras import camera_from_rt
from bloomscene_tpu_torch.train import loop as loop_mod
from bloomscene_tpu_torch.train.loop import Trainer
from bloomscene_tpu_torch.utils import profiling

SIZE = 32
BASE = dict(voxel_size=0.08, max_splats_per_tile=2048, start_stat=0,
            update_from=10 ** 9, update_interval=40, update_until=10 ** 9,
            densify_pause_from=10 ** 9, noise_from_step=10 ** 9,
            context_from_step=10 ** 9, visible_capacity=256)
READ_SPANS = {"loop.wait", "loop.settle", "loop.records"}
LOOP_SPANS = {"loop.draws", "loop.scalars", "loop.stage"} | READ_SPANS


def sphere_points(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    th, ph = rng.uniform(0, np.pi, n), rng.uniform(0, 2 * np.pi, n)
    pts = np.stack([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph),
                    np.cos(th)], -1).astype(np.float32) * 0.7
    pts[:, 2] += 2.5
    return pts


def views(device: str) -> tuple:
    yy, xx = np.mgrid[0:SIZE, 0:SIZE]
    inside = (xx - SIZE // 2) ** 2 + (yy - SIZE // 2) ** 2 < (SIZE // 3) ** 2
    img = np.zeros((SIZE, SIZE, 3), np.float32)
    img[inside] = [0.8, 0.4, 0.2]
    depth = np.where(inside, 2.5, 0.0).astype(np.float32)
    out = []
    for k in range(2):
        cam = camera_from_rt(np.eye(3), np.array([0.1 * k, 0.0, 0.0]), 1.0,
                             1.0, SIZE, SIZE)
        out.append((cam.device_arrays(device),
                    torch.from_numpy(img).to(device),
                    torch.from_numpy(depth).to(device)))
    return cam, out


def trainer(device: str, **kw) -> tuple:
    cfg = GSConfig(**{**BASE, **kw})
    cam, vs = views(device)
    model, voxel = init_model(2, sphere_points(250, 3), cfg, capacity=512,
                              device=device)
    return Trainer(model, cfg, cam.intrinsics, voxel, seed=11,
                   device=device), vs


@pytest.fixture
def stamp_rows(monkeypatch):
    """Each chunk's stamp rows, its slot table and its first stamped
    row, as ``ChunkTimer.stamped`` receives them."""
    seen = []
    orig = loop_mod.ChunkTimer.stamped

    def spy(self, rows, table, stamped_from, prev):
        seen.append((rows.copy(), table, stamped_from))
        return orig(self, rows, table, stamped_from, prev)
    monkeypatch.setattr(loop_mod.ChunkTimer, "stamped", spy)
    return seen


def test_device_loop_stamps_every_slot_every_step(stamp_rows):
    torch.set_num_threads(2)
    tr, vs = trainer("cpu", remat=True)
    tr.run(vs, iterations=10, log_every=100, device_loop=True, max_chunk=4)
    assert [c["last"] - c["first"] + 1 for c in tr.chunk_log] == [4, 4, 2]
    assert len(stamp_rows) == 3
    for rec, (rows, table, start) in zip(tr.chunk_log, stamp_rows):
        S = len(table)
        assert start == 0 and rec["stamped_steps"] == rows.shape[0]
        assert S > 30 and table[0] == ("train.step", profiling.ENTER)
        assert table[-1] == ("train.step", profiling.EXIT)
        t = rows[:, :S]
        assert (t > 0).all() and (rows[:, S:] == 0).all()
        flat = t.reshape(-1)
        assert (np.diff(flat) >= 0).all()
        interval = (flat[-1] - flat[0]) / 1e6
        total = sum(rec["span_ms"].values()) + rec["step_gap_ms"]
        assert total == pytest.approx(interval, rel=1e-9)
        assert rec["stamps_ns"] == [int(flat[0]), int(flat[-1])]
    recs = tr.chunk_log
    assert recs[0]["boundary_idle_ms"] is None
    for prev, rec in zip(recs, recs[1:]):
        assert rec["boundary_idle_ms"] == pytest.approx(
            (rec["stamps_ns"][0] - prev["stamps_ns"][1]) / 1e6)


@pytest.mark.parametrize("remat", [False, True])
def test_recompute_spans_only_under_remat(remat):
    torch.set_num_threads(2)
    tr, vs = trainer("cpu", remat=remat)
    tr.run(vs, iterations=2, log_every=100, device_loop=True, max_chunk=2)
    paths = tr.chunk_log[0]["span_ms"]
    first = {"train.step/train.forward/" + n for n in (
        "render.compact", "render.decode", "render.bin",
        "tile_blend.forward", "train.losses")}
    assert first <= set(paths)
    assert "train.step/train.backward/tile_blend.backward/tile_blend.reduce" \
        in paths
    assert "train.step/train.backward/gather_rows.backward" in paths
    again = {p for p in paths if p.startswith("train.step/train.backward/")
             and p.split("/")[2].startswith("render.")}
    want = {"train.step/train.backward/" + n for n in (
        "render.compact", "render.decode", "render.bin")}
    assert again == (want if remat else set())
    assert ("train.step/train.backward/tile_blend.forward" in paths) == remat


@pytest.mark.parametrize("log_every", [1, 100])
def test_host_ms_names_every_loop_span(log_every):
    """A schedule with a bounds refresh (step 4) and a surgery (step 6)
    at chunk ends: every chunk names its host spans, and each boundary
    after the first is split into named spans and the unnamed rest. Only
    a chunk with a logged step (every chunk, or the run's last) waits for
    the device and reads its records."""
    torch.set_num_threads(2)
    tr, vs = trainer("cpu", start_stat=1, update_from=2, update_interval=3,
                     update_until=7, context_from_step=4)
    tr.run(vs, iterations=8, log_every=log_every, device_loop=True,
           max_chunk=3)
    recs = tr.chunk_log
    assert [c["surgery"] for c in recs].count(True) >= 1
    assert len(recs) >= 3
    seen = set()
    for i, rec in enumerate(recs):
        host = rec["host_ms"]
        reads = log_every == 1 or rec["last"] == 8
        assert LOOP_SPANS - READ_SPANS | {"loop.eager"} <= set(host)
        assert (READ_SPANS <= set(host)) == reads
        assert not reads or rec["stamped_steps"] > 0
        assert all(v >= 0 for v in host.values())
        seen |= set(host)
        if i == 0:
            assert "unnamed" not in host
            continue
        assert 0 <= host["unnamed"] <= rec["boundary_idle_ms"]
        assert rec["clock_offset_ns"] == 0      # the host's clock
    assert {"loop.surgery", "loop.bounds", "unnamed"} <= seen
    names = {r.name for r in tr.spans.records}
    assert names == LOOP_SPANS | {"loop.eager", "loop.surgery",
                                  "loop.bounds"}


def test_nested_spans_keep_their_parent():
    spans = profiling.Spans()
    with spans.span("outer"):
        with spans.span("inner"):
            with spans.span("leaf"):
                pass
        with spans.span("inner"):
            pass

    def other():
        with spans.span("thread"):
            pass
    with spans.span("main"):
        th = threading.Thread(target=other)
        th.start()
        th.join(timeout=30)
    assert not th.is_alive()
    recs = {(r.name, i): r for i, r in enumerate(spans.records)}
    by_name = [r.name for r in spans.records]
    assert by_name == ["outer", "inner", "leaf", "inner", "main", "thread"]
    parents = [r.parent for r in spans.records]
    assert parents == [None, 0, 1, 0, None, None]
    assert all(r.end_ns >= r.start_ns for r in recs.values())
    own = spans.self_ms()
    total = sum((r.end_ns - r.start_ns) / 1e6 for r in spans.records
                if r.parent is None)
    assert sum(own.values()) == pytest.approx(total)
    assert spans.summary()["inner"]["count"] == 2


def test_step_times_by_hand():
    E, X = profiling.ENTER, profiling.EXIT
    table = (("a", E), ("a/b", E), ("a/b", X), ("a/c", E), ("a/c", X),
             ("a", X))
    rows = np.array([[10, 12, 17, 17, 20, 21, 0],
                     [30, 31, 33, 35, 38, 40, 0]], np.int64)
    t = profiling.step_times(rows, table)
    # a: 2 + 0 + 1 and 1 + 2 + 2; b: 5 and 2; c: 3 and 3; gap 30 - 21
    assert t["span_ms"] == pytest.approx({"a": 8e-6, "a/b": 7e-6,
                                          "a/c": 6e-6})
    assert t["step_gap_ms"] == pytest.approx(9e-6)
    assert (t["first_ns"], t["last_ns"]) == (10, 40)
    assert t["stamped_steps"] == 2
    assert profiling.covered_ns(0, 10, [(2, 4), (3, 6), (8, 20)]) == 6


def test_graph_kernels_by_span():
    """Kernels go to the last stamp among their ancestors: k0 before any
    stamp, k1 and k2 after stamp 0 (inside "a"), k3 on a side branch that
    joins after stamp 1, k4 after the last stamp."""
    E, X = profiling.ENTER, profiling.EXIT
    table = (("a", E), ("a/b", E), ("a/b", X), ("a", X))
    types = ["kernel"] * 9 + ["memset"]
    slots = [-1, 0, -1, -1, 1, -1, 2, 3, -1, -1]
    # k0 -> s0 -> k1 -> s1 -> k2(node 5) -> s2 -> s3 -> k4(node 8);
    # k1 -> k3 (node 3) -> s2; memset (node 9) -> k3
    edges = [(0, 1), (1, 2), (2, 4), (4, 5), (5, 6), (6, 7), (7, 8),
             (2, 3), (3, 6), (9, 3)]
    got = profiling.graph_kernels({"types": types, "slots": slots,
                                   "edges": edges}, table)
    assert got["by_type"] == {"kernel": 9, "memset": 1}
    assert got["stamps"] == 4
    assert got["kernels_by_span"] == {"": 2, "a": 2, "a/b": 1}


def test_idle_stamps_leave_the_graph():
    """s2 follows s1 and s4 follows s3 with no work between (an event
    record does none); s1 follows k0, s3 follows k1. The idle stamps leave
    the counts, and their columns take the stamp's before them."""
    E, X = profiling.ENTER, profiling.EXIT
    table = (("a", E), ("a/b", E), ("a/b", X), ("a/c", E), ("a/c", X),
             ("a", X))
    # s0 -> k0 -> s1 -> s2 -> k1 -> s3 -> event -> s4 -> k2 -> s5
    types = ["kernel"] * 9 + ["event_record"]
    slots = [0, -1, 1, 2, -1, 3, 4, -1, 5, -1]
    edges = [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (5, 9), (9, 6),
             (6, 7), (7, 8)]
    census = {"types": types, "slots": slots, "edges": edges}
    idle = profiling.idle_stamps(census)
    assert idle == {2, 4}
    got = profiling.graph_kernels(census, table, idle)
    assert got["stamps"] == 4 and got["stamps_dropped"] == 2
    assert got["by_type"] == {"kernel": 7, "event_record": 1}
    # k0, k1 and k2 each follow a stamp after which "a" alone is open
    assert got["kernels_by_span"] == {"a": 3}
    kept = [s not in idle for s in range(len(table))]
    # columns 2 and 4 hold what the graph left there (never written)
    rows = np.array([[10, 14, 15, 20, -1, 26, 0],
                     [30, 33, 34, 41, -1, 44, 0]], np.int64)
    filled = profiling.fill_dropped(rows, kept)
    assert filled[:, 2].tolist() == [14, 33]
    assert filled[:, 4].tolist() == [20, 41]
    assert rows[0, 2] == 15       # the input is left as it was
    t = profiling.step_times(filled, table)
    # a/b: 0; a/c: 0; a: 4 + 6 + 6 and 3 + 8 + 3
    assert t["span_ms"] == pytest.approx({"a": 30e-6, "a/b": 0.0,
                                          "a/c": 0.0})
    # no stamp leaves where work lies between, and never slot 0
    chain = {"types": ["kernel"] * 5, "slots": [0, -1, 1, -1, 2],
             "edges": [(0, 1), (1, 2), (2, 3), (3, 4)]}
    assert profiling.idle_stamps(chain) == set()
    assert profiling.idle_stamps({"types": ["kernel"] * 2, "slots": [0, 1],
                                  "edges": [(0, 1)]}) == {1}


def test_trace_export_holds_program_spans(tmp_path):
    spans = profiling.Spans()
    with spans.span("before"):
        pass
    with profiling.trace(str(tmp_path), spans=spans) as prof:
        with spans.span("loop.outer"):
            with spans.span("loop.inner"):
                torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    assert any("mm" in e.key for e in prof.key_averages())
    with open(tmp_path / "trace.json") as f:
        doc = json.load(f)
    mine = [e for e in doc["traceEvents"]
            if e.get("cat") == "program_span"]
    assert [e["name"] for e in mine] == ["loop.outer", "loop.inner"]
    theirs = {e["name"]: e for e in doc["traceEvents"]
              if e.get("name", "").startswith("loop.")
              and e.get("cat") != "program_span"}
    for e in mine:
        # placed within a few hundred us of the profiler's own record
        assert abs(e["ts"] - theirs[e["name"]]["ts"]) < 500
    outer, inner = mine
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-3


# --- on the card ----------------------------------------------------------

def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_stamp_builds_without_spill():
    card()
    from bloomscene_tpu_torch.ops.cuda import build
    build.library("stamp")
    log = build.build_log("stamp")
    assert "stamp_kernel" in log or "Used" in log
    assert "bytes spill" in log
    assert all(int(a) == 0 and int(b) == 0 for a, b in __import__("re")
               .findall(r"(\d+) bytes spill stores, (\d+) bytes spill "
                        r"loads", log))


@pytest.mark.cuda
def test_timer_resolution():
    """Stamps in a graph's chain, replayed: they never go back, nodes
    follow each other within 5 us, and the timer's resolution (the
    greatest common divisor of the steps between them) is at most 1 us."""
    dev = card()
    from bloomscene_tpu_torch.ops.cuda.stamp import stamp
    n = 256
    stamps = torch.zeros((1, n), dtype=torch.int64, device=dev)
    counter = torch.zeros((1,), dtype=torch.int64, device=dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        stamp(stamps, counter, 0)
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin()
        for slot in range(n):
            stamp(stamps, counter, slot)
        graph.capture_end()
    torch.cuda.current_stream(dev).wait_stream(side)
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    steps = np.diff(stamps.cpu().numpy()[0])
    assert (steps >= 0).all()
    resolution = int(np.gcd.reduce(steps[steps > 0]))
    print(f"globaltimer: resolution {resolution} ns; steps between stamp "
          f"nodes: least nonzero {steps[steps > 0].min()} ns, median "
          f"{int(np.median(steps))} ns")
    assert resolution <= 1000
    assert np.median(steps) <= 5000


@pytest.mark.cuda
def test_stamps_differ_across_replays():
    """A stamp captured in a graph writes the counter's row at each
    replay, with a later time each time; the census finds it. Slot 3
    follows slot 2 with no work between: it leaves the graph, which then
    runs without it and never writes its column."""
    dev = card()
    from bloomscene_tpu_torch.ops.cuda.stamp import (drop_stamps,
                                                     graph_census, stamp)
    rows, slots = 6, 5
    stamps = torch.zeros((rows, slots), dtype=torch.int64, device=dev)
    counter = torch.zeros((1,), dtype=torch.int64, device=dev)
    x = torch.zeros((1 << 20,), device=dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        stamp(stamps, counter, 0)          # warm-up, row 0
        x.add_(1.0)
        counter.add_(1)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        graph.capture_begin()
        stamp(stamps, counter, 1)
        x.add_(1.0)
        stamp(stamps, counter, 2)
        stamp(stamps, counter, 3)
        counter.add_(1)
        graph.capture_end()
    torch.cuda.current_stream(dev).wait_stream(side)
    census = graph_census(graph.raw_cuda_graph())
    assert sorted(s for s in census["slots"] if s >= 0) == [1, 2, 3]
    assert census["types"].count("kernel") == 5
    idle = profiling.idle_stamps(census)
    assert idle == {3}
    launched = stamp.launches
    assert drop_stamps(graph.raw_cuda_graph(), idle, slots) == 1
    assert stamp.launches == launched - 1
    after = graph_census(graph.raw_cuda_graph())
    assert sorted(s for s in after["slots"] if s >= 0) == [1, 2]
    assert len(after["edges"]) == 3        # the chain, joined round slot 3
    graph.instantiate()
    for _ in range(rows - 1):
        graph.replay()
    torch.cuda.synchronize()
    got = stamps.cpu().numpy()
    t = got[1:, 1:3]
    assert (t > 0).all() and (np.diff(t.reshape(-1)) >= 0).all()
    assert len(set(t[:, 0])) == rows - 1
    assert (got[1:, 3:] == 0).all() and (got[1:, 0] == 0).all()
    assert float(x[0]) == rows


@pytest.mark.cuda
def test_graph_records_its_kernels_by_span():
    dev = card()
    tr, vs = trainer(dev.type, remat=True)
    tr.run(vs, iterations=4, log_every=100, device_loop=True, max_chunk=4)
    g = tr.graph_log[0]
    nodes, graph = g["nodes"], tr._graphs[0, True]
    assert nodes["stamps"] == sum(graph.kept)
    assert nodes["stamps_dropped"] == len(graph.slots) - sum(graph.kept)
    assert 0 < nodes["stamps_dropped"] < len(graph.slots) // 2
    assert g["launches"]["stamp"] == nodes["stamps"]
    assert nodes["by_type"]["kernel"] == nodes["stamps"] + sum(
        nodes["kernels_by_span"].values())
    by_span = nodes["kernels_by_span"]
    assert by_span["train.step/train.backward/tile_blend.backward/"
                   "tile_blend.k2"] >= 1
    rec = tr.chunk_log[0]
    assert rec["stamped_steps"] == 3 and rec["eager_steps"] == 1
    total = sum(rec["span_ms"].values()) + rec["step_gap_ms"]
    assert total == pytest.approx(g["replay_ms"], rel=0.05)


@pytest.mark.cuda
def test_profiler_shares_the_program_clock(tmp_path, stamp_rows):
    """With the profiler on the host and the card: every graph launch lies
    inside a ``loop.enqueue`` span, and every stamp kernel starts within
    50 us of its stamp placed on the host's clock by the run's offset and
    on the profiler's by ``profiler_offset_ns``. A record each step, as
    the benchmark's runs log: each chunk waits, and the offset is the
    least of three."""
    dev = card()
    tr, vs = trainer(dev.type, remat=True)
    run = dict(log_every=1, device_loop=True, max_chunk=4)
    tr.run(vs, iterations=8, **run)
    lo, n_chunks = len(tr.spans.records), len(tr.chunk_log)
    stamp_rows.clear()
    with profiling.trace(str(tmp_path), spans=tr.spans) as prof:
        tr.run(vs, iterations=20, **run)
    off = profiling.profiler_offset_ns(prof, tr.spans, lo)
    print(f"profiler clock less CLOCK_MONOTONIC: {off} ns")
    events = prof.profiler.kineto_results.events()
    enq = [(r.start_ns + off, r.end_ns + off)
           for r in tr.spans.records[lo:] if r.name == "loop.enqueue"]
    launches = [e for e in events if e.name() == "cudaGraphLaunch"]
    assert launches
    for e in launches:
        a, b = e.start_ns(), e.start_ns() + e.duration_ns()
        assert any(s <= a and b <= t for s, t in enq), (a, b)
    kernels = sorted(e.start_ns() for e in events
                     if "stamp_kernel" in e.name()
                     and e.device_type() == torch.autograd.DeviceType.CUDA)
    recs = tr.chunk_log[n_chunks:]
    # the eager steps' stamps, and the replays' that their graph kept
    kept = np.asarray(tr._graphs[0, True].kept)
    placed = []
    for rec, (rows, table, start) in zip(recs, stamp_rows):
        t = rows[:, :len(table)] + rec["clock_offset_ns"] + off
        placed += list(t[:start].reshape(-1)) + list(
            t[start:, kept].reshape(-1))
    assert len(kernels) == len(placed)
    gaps = np.abs(np.asarray(kernels) - np.asarray(placed))
    print(f"stamp kernels against their placed stamps: median "
          f"{int(np.median(gaps))} ns, largest {int(gaps.max())} ns")
    assert gaps.max() <= 50_000
