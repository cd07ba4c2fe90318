"""The port's pipeline schedulers (paddle_tpu_torch/distributed/passes)
against the JAX package's: the same instruction list for every rank, the
same simulated makespan, bubble and peak in-flight count, and the
reference's validity cases (tests/test_pipeline_schedules.py:12-60). Pure
Python: no ranks are spawned."""
import pytest

from paddle_tpu.distributed import passes as jp

from paddle_tpu_torch.distributed import passes as tp
from paddle_tpu_torch.distributed.fleet.meta_parallel.pipeline_spmd import (
    _check_order, schedule_instructions)

SCHEDULES = ("FThenB", "OneFOneB", "Eager1F1B", "ZeroBubbleH1")


def _lists(mod, name, S, M, V=1):
    cls = getattr(mod, name)
    sched = cls(S, M, num_chunks=V) if V > 1 else cls(S, M)
    return [[tuple(i) for i in sched.rank_instructions(r)] for r in range(S)]


@pytest.mark.parametrize("name", SCHEDULES)
@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("M", [1, 4, 8])
def test_rank_lists_equal_the_jax_package(name, S, M):
    assert _lists(tp, name, S, M) == _lists(jp, name, S, M)
    ours = tp.simulate_schedule(getattr(tp, name)(S, M))
    assert ours == jp.simulate_schedule(getattr(jp, name)(S, M))


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("M", [4, 8])
@pytest.mark.parametrize("V", [1, 2])
def test_interleaved_lists_equal_the_jax_package(S, M, V):
    assert _lists(tp, "InterleavedOneFOneB", S, M, V) == \
        _lists(jp, "InterleavedOneFOneB", S, M, V)
    assert tp.simulate_schedule(tp.InterleavedOneFOneB(S, M, num_chunks=V)) \
        == jp.simulate_schedule(jp.InterleavedOneFOneB(S, M, num_chunks=V))


@pytest.mark.parametrize("S,M,V", [(2, 1, 1), (2, 4, 1), (4, 8, 1),
                                   (2, 4, 2), (4, 8, 2), (2, 8, 2)])
def test_executor_lists_and_message_order(S, M, V):
    """The executor runs the scheduler's lists, and every sender posts its
    messages to a peer in the order the peer receives them."""
    lists = [schedule_instructions(S, M, V, r) for r in range(S)]
    cls = tp.InterleavedOneFOneB(S, M, V) if V > 1 else tp.OneFOneB(S, M)
    assert lists == cls.all_instructions()
    _check_order(S, V, lists)


@pytest.mark.parametrize("sched_cls", ["FThenB", "OneFOneB", "Eager1F1B",
                                       "ZeroBubbleH1"])
@pytest.mark.parametrize("S,M", [(2, 4), (4, 8), (4, 4), (3, 9)])
def test_no_deadlock_all_complete(sched_cls, S, M):
    assert tp.simulate_schedule(getattr(tp, sched_cls)(S, M))["makespan"] > 0


def test_reference_structure_cases():
    S, M = 4, 16
    assert max(tp.simulate_schedule(tp.OneFOneB(S, M))["peak_inflight"]) \
        <= S
    assert max(tp.simulate_schedule(tp.FThenB(S, M))["peak_inflight"]) == M
    assert tp.simulate_schedule(tp.ZeroBubbleH1(4, 8))["bubble_ratio"] <= \
        tp.simulate_schedule(tp.OneFOneB(4, 8))["bubble_ratio"]
    kinds = [i.kind for i in tp.ZeroBubbleH1(2, 4).rank_instructions(0)]
    assert (kinds.count("F"), kinds.count("B"), kinds.count("W")) == \
        (4, 4, 4)
    kinds = [i.kind for i in tp.OneFOneB(4, 8).rank_instructions(0)]
    assert kinds[:4] == ["F"] * 4 and kinds[4:12] == ["B", "F"] * 4 \
        and kinds[12:] == ["B"] * 4
    assert [i.kind for i in tp.OneFOneB(4, 8).rank_instructions(3)][:2] == \
        ["F", "B"]
    with pytest.raises(ValueError):
        tp.InterleavedOneFOneB(4, 6, num_chunks=2).rank_instructions(0)


def test_split_backward_lists_are_not_executed():
    from paddle_tpu_torch.distributed.fleet.meta_parallel.pipeline_spmd \
        import _messages
    with pytest.raises(NotImplementedError, match="ZeroBubbleH1"):
        _messages(tp.ZeroBubbleH1(2, 4).rank_instructions(0), 0, 2, 1)
