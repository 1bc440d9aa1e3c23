"""The port's Prefetcher and StragglerMonitor: the non-fault cases of the
reference's ``tests/test_pipeline.py`` (limit, exception surfacing on
get() and close(), the pre-batch hook's order and its serialization with
the build pool, pool order, summary, start_step), run against the port."""
import queue
import threading
import time

import pytest

from repro_torch.train.pipeline import Prefetcher, StragglerMonitor


def _wait_worker_done(p, timeout=5.0):
    t0 = time.time()
    while p._thread.is_alive() and time.time() - t0 < timeout:
        time.sleep(0.01)
    assert not p._thread.is_alive()


def test_prefetcher_produces_limit_batches():
    p = Prefetcher(lambda step: {"step": step}, depth=2, limit=3)
    assert [p.get()["step"] for _ in range(3)] == [0, 1, 2]
    p.close()
    assert p.summary()["batches_built"] == 3


def test_worker_exception_surfaces_on_get():
    def bad(step):
        raise RuntimeError("boom")

    p = Prefetcher(bad, depth=2, limit=4)
    _wait_worker_done(p)
    with pytest.raises(RuntimeError, match="boom"):
        p.get(timeout=5)
    p.close()  # already surfaced once: close() does not raise it again


def test_worker_exception_surfaces_on_close():
    def bad(step):
        if step >= 1:
            raise RuntimeError("late failure")
        return {"step": step}

    p = Prefetcher(bad, depth=4, limit=4)
    _wait_worker_done(p)  # the consumer never looks at the queue again
    with pytest.raises(RuntimeError, match="late failure"):
        p.close()


def test_pre_batch_hook_runs_before_each_batch_in_order():
    seen = []
    p = Prefetcher(lambda step: {"step": step}, depth=2, limit=3,
                   pre_batch_hook=seen.append)
    for _ in range(3):
        p.get()
    p.close()
    assert seen == [0, 1, 2]


def test_pre_batch_hook_exception_surfaces_on_close():
    def hook(step):
        if step == 1:
            raise ValueError("hook died")

    p = Prefetcher(lambda step: {"step": step}, depth=4, limit=4,
                   pre_batch_hook=hook)
    _wait_worker_done(p)
    with pytest.raises(ValueError, match="hook died"):
        p.close()


def test_worker_exception_surfaces_promptly_while_blocked():
    def bad(step):
        time.sleep(0.3)  # let the consumer block on the empty queue first
        raise RuntimeError("late boom")

    p = Prefetcher(bad, depth=2, limit=2)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="late boom"):
        p.get(timeout=60.0)
    assert time.monotonic() - t0 < 5.0
    p.close()


def test_get_timeout_still_raises_empty():
    p = Prefetcher(lambda step: time.sleep(10), depth=1, limit=1)
    with pytest.raises(queue.Empty):
        p.get(timeout=0.2)
    p._stop.set()  # do not wait for the sleeping build at close


def test_part_fns_build_concurrently_and_deliver_in_order():
    gate = threading.Barrier(3, timeout=10)

    def make(i):
        def fn(step):
            gate.wait()  # deadlocks unless all three run concurrently
            return (i, step)
        return fn

    p = Prefetcher(part_fns=[make(i) for i in range(3)], workers=3,
                   depth=2, limit=2)
    assert p.get(timeout=10) == [(0, 0), (1, 0), (2, 0)]
    assert p.get(timeout=10) == [(0, 1), (1, 1), (2, 1)]
    p.close()
    assert p.summary()["build_workers"] == 3


def test_part_fns_workers_one_is_serial():
    order = []

    def make(i):
        def fn(step):
            order.append((step, i))
            return i
        return fn

    p = Prefetcher(part_fns=[make(i) for i in range(3)], workers=1,
                   depth=2, limit=2)
    assert p.get(timeout=10) == [0, 1, 2]
    assert p.get(timeout=10) == [0, 1, 2]
    p.close()
    assert order == [(0, 0), (0, 1), (0, 2), (1, 0), (1, 1), (1, 2)]


def test_hook_serialized_with_pool_builds():
    in_flight, max_seen, hook_calls = [], [], []
    lock = threading.Lock()

    def make(i):
        def fn(step):
            with lock:
                in_flight.append(i)
                max_seen.append(len(in_flight))
            time.sleep(0.02)
            with lock:
                in_flight.remove(i)
            return i
        return fn

    def hook(step):
        assert not in_flight, f"hook ran with builds in flight: {in_flight}"
        hook_calls.append(step)

    p = Prefetcher(part_fns=[make(i) for i in range(4)], workers=4,
                   depth=2, limit=3, pre_batch_hook=hook)
    for _ in range(3):
        p.get(timeout=10)
    p.close()
    assert hook_calls == [0, 1, 2]
    assert max(max_seen) > 1, "parts never actually overlapped"


def test_part_fn_exception_surfaces():
    def make(i):
        def fn(step):
            if i == 2 and step == 1:
                raise RuntimeError("part died")
            return i
        return fn

    p = Prefetcher(part_fns=[make(i) for i in range(3)], depth=4, limit=4)
    with pytest.raises(RuntimeError, match="part died"):
        assert p.get(timeout=10) == [0, 1, 2]
        p.get(timeout=10)
    p.close()


def test_summary_reports_queue_dry_time():
    def slow(step):
        time.sleep(0.15)
        return {"step": step}

    p = Prefetcher(slow, depth=2, limit=2)
    p.get()
    p.get()
    p.close()
    s = p.summary()
    assert s["queue_dry_s_total"] >= 0.1  # the consumer really waited
    assert s["queue_dry_s_mean"] > 0 and s["build_workers"] == 1
    assert s["host_build_s_total"] >= 0.25 and s["gets"] == 2


def test_constructor_validation():
    with pytest.raises(ValueError, match="exactly one"):
        Prefetcher()
    with pytest.raises(ValueError, match="exactly one"):
        Prefetcher(lambda s: s, part_fns=[lambda s: s])
    with pytest.raises(ValueError, match="not be empty"):
        Prefetcher(part_fns=[])


def test_extra_summary_collision_raises_and_namespaced_keys_merge():
    p = Prefetcher(lambda step: {"step": step}, depth=1, limit=1,
                   extra_summary=lambda: {"batches_built": 999,
                                          "queue_dry_s_total": 0})
    p.get()
    p.close()
    with pytest.raises(ValueError, match=r"batches_built.*queue_dry_s_total"):
        p.summary()
    p = Prefetcher(lambda step: {"step": step}, depth=1, limit=1,
                   extra_summary=lambda: {"sampling/syncs": 7})
    p.get()
    p.close()
    assert p.summary()["sampling/syncs"] == 7


def test_summary_on_zero_batches():
    p = Prefetcher(lambda step: {"step": step}, depth=1, limit=0)
    p.close()
    s = p.summary()
    assert s["batches_built"] == 0
    assert s["host_build_s_mean"] == 0 and s["queue_dry_s_mean"] == 0


def test_start_step_offsets_the_build_sequence():
    seen = []
    p = Prefetcher(lambda step: {"step": step}, depth=2, limit=3,
                   pre_batch_hook=seen.append, start_step=10)
    assert [p.get()["step"] for _ in range(3)] == [10, 11, 12]
    p.close()
    assert seen == [10, 11, 12]


def test_straggler_monitor_flags_outliers_and_keeps_the_ewma():
    m = StragglerMonitor(alpha=0.5, threshold=2.0)
    flags = [m.record(t) for t in (1.0, 1.2, 5.0, 0.8)]
    assert flags == [False, False, True, False]
    s = m.summary()
    assert s["steps"] == 4 and s["stragglers"] == 1 and s["worst_s"] == 5.0
    # the straggler did not move the EWMA: 1.0 -> 1.1 -> (skip) -> 0.95
    assert s["ewma_s"] == pytest.approx(0.95)


@pytest.mark.parametrize("workers", [1, 3])
def test_part_groups_nest_per_clique_and_pack_runs_after_the_barrier(workers):
    """``part_group_sizes`` regroups the (concurrently built) parts per
    clique, and ``pack_fn`` sees each whole step on the coordinator thread
    after every part landed, timed apart from the build."""
    built, packed_on = [], []

    def part(i):
        def fn(step):
            built.append((step, i))
            return (step, i)
        return fn

    def pack(groups):
        packed_on.append(threading.current_thread().name)
        step = groups[0][0][0]
        assert sorted(built[-3:]) == [(step, 0), (step, 1), (step, 2)]
        time.sleep(0.02)
        return {"groups": groups}

    p = Prefetcher(part_fns=[part(i) for i in range(3)],
                   part_group_sizes=[1, 2], pack_fn=pack, workers=workers,
                   depth=1, limit=2)
    got = [p.get()["groups"] for _ in range(2)]
    p.close()
    assert got == [[[(s, 0)], [(s, 1), (s, 2)]] for s in (0, 1)]
    assert all(not n.startswith("prefetch-build") for n in packed_on)
    s = p.summary()
    assert s["host_pack_s_total"] >= 0.04 and s["host_pack_s_mean"] > 0


@pytest.mark.parametrize("sizes", [[1, 1], [2, 0, 1], [4]])
def test_part_group_sizes_must_cover_the_parts(sizes):
    with pytest.raises(ValueError, match="part_group_sizes"):
        Prefetcher(part_fns=[lambda s: s] * 3, part_group_sizes=sizes)
    with pytest.raises(ValueError, match="needs part_fns"):
        Prefetcher(lambda s: s, part_group_sizes=[1])
