"""The pipeline executor: one rank's 1F1B or interleaved instruction list
run over send/recv (counterpart of
paddle_tpu/distributed/fleet/meta_parallel/pipeline_spmd.py).

The JAX package stores a homogeneous stack with a leading stage axis
sharded over the 'pp' mesh axis and runs a shift register (scan +
ppermute) whose transpose gives the backward. Here each pp rank holds
only its own stage, as Paddle's pipeline_parallel.py:459 does, and
``run_schedule`` executes this rank's list from the port's schedulers
(``OneFOneB(S, M).rank_instructions(rank)``, or ``InterleavedOneFOneB(S,
M, V)`` for V chunks a rank):

- F(m, c): the input of virtual stage v = c S + s (s this rank) is
  microbatch m on v = 0, else the activation virtual stage v - 1 sent;
  the chunk runs forward under autograd; the last virtual stage applies
  the loss, any other sends its output to virtual stage v + 1;
- B(m, c): the last virtual stage backpropagates its loss, any other the
  gradient virtual stage v + 1 sent back; then, but on v = 0, the input's
  gradient goes to virtual stage v - 1.

After each instruction, the send it produced and the receive the next
instruction needs are posted together as one ``batch_isend_irecv`` (the
steady state's "send this forward, receive that gradient" pair of
Paddle's p2p_communication), so no rank blocks in a lone send. Virtual
stage k lives on rank k mod S, so stage S-1's chunk c feeds stage 0's
chunk c + 1. Messages between two ranks are matched in the order they
are posted, so the executor checks once per schedule that every sender
posts its messages to a peer in the order the peer consumes them.

The first message on each directed pair of a run is preceded by a meta
message (rank, shape, dtype), from which the receiver shapes its buffers,
as Paddle's p2p does; every later message on the pair must match it.
CUDA tensors on a gloo group go through host memory (collective.py's
``p2p_host_staged``).

The storage of a microbatch in flight is its autograd graph, from its F
to its B: the JAX package's ``save_mode`` / ``carry_spec`` knobs say how
XLA stores a traced scan and have no counterpart here. The models'
configs validate ``pipeline_save_mode`` as the reference does
(models/llama.py's ``check_pipeline_save_mode``), and every valid value
runs this one executor.
"""
from __future__ import annotations

import collections
import time

import torch

from ...collective import P2POp, batch_isend_irecv, broadcast, irecv, isend
from ...passes import InterleavedOneFOneB, OneFOneB

__all__ = ["run_schedule", "spmd_pipeline", "spmd_pipeline_interleaved",
           "schedule_instructions", "broadcast_from_last"]

_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64,
           torch.int64, torch.int32)
_META_LEN = 10                   # [ndim, dtype code, up to 8 dims]


def schedule_instructions(num_stages, num_micro, num_chunks, rank):
    """This rank's instruction list: 1F1B, or interleaved 1F1B for more
    than one chunk a rank."""
    if num_chunks > 1:
        return InterleavedOneFOneB(num_stages, num_micro,
                                   num_chunks).rank_instructions(rank)
    return OneFOneB(num_stages, num_micro).rank_instructions(rank)


def _messages(instrs, rank, S, V):
    """(sends, recvs) of one rank's list: {peer stage: [message key]} in
    the order the list posts them. A key is ("a", m, v) for the
    activation virtual stage v sends forward, ("g", m, v) for the
    gradient it sends back."""
    last = S * V - 1
    sends, recvs = {}, {}
    for ins in instrs:
        v = ins.chunk * S + rank
        if ins.kind == "F":
            if v > 0:
                recvs.setdefault((rank - 1) % S, []).append(("a", ins.microbatch, v - 1))
            if v < last:
                sends.setdefault((rank + 1) % S, []).append(("a", ins.microbatch, v))
        elif ins.kind == "B":
            if v < last:
                recvs.setdefault((rank + 1) % S, []).append(("g", ins.microbatch, v + 1))
            if v > 0:
                sends.setdefault((rank - 1) % S, []).append(("g", ins.microbatch, v))
        else:
            raise NotImplementedError(
                f"instruction {ins.kind}: a split weight-gradient step "
                f"(ZeroBubbleH1) is not run by the executor")
    return sends, recvs


_CHECKED = set()


def _check_order(S, V, lists):
    """Every rank posts its messages to a peer in the order the peer
    consumes them (p2p matches in posting order)."""
    key = (S, V, tuple(tuple(lst) for lst in lists))
    if key in _CHECKED:
        return
    msgs = [_messages(lst, r, S, V) for r, lst in enumerate(lists)]
    for r in range(S):
        for peer, seq in msgs[r][0].items():
            got = msgs[peer][1].get(r, [])
            if seq != got:
                raise RuntimeError(
                    f"pipeline schedule: stage {r} sends {seq} to stage "
                    f"{peer}, which receives {got} in that order")
    _CHECKED.add(key)


def _meta(t):
    m = torch.zeros(_META_LEN, dtype=torch.int64)
    m[0], m[1] = t.dim(), _DTYPES.index(t.dtype)
    m[2:2 + t.dim()] = torch.tensor(t.shape, dtype=torch.int64)
    return m


class _Wire:
    """The p2p of one run: sends with their meta, receives shaped from
    it, and the run's byte and wait counts."""

    def __init__(self, group, device, timed):
        self.group = group
        self.device = device
        self.timed = timed
        self.meta_sent = {}          # peer stage -> (shape, dtype)
        self.meta_recv = {}
        self.pending = []            # send tasks and what they hold
        self.local = collections.deque()   # messages to this rank itself
        self.bytes = 0
        self.messages = 0
        self.wait_s = 0.0

    def _peer(self, stage):
        return self.group.ranks[stage]

    def post(self, send=None, recv=None):
        """Post one batch: ``send`` = (peer stage, tensor) and the receive
        ``recv`` = peer stage; returns the receive's (task, buffer), or
        None when ``take`` finds it in the local queue."""
        ops = []
        # one stage holding consecutive chunks passes to itself
        if send is not None and send[0] == self.group.rank:
            self.local.append(send[1])
            send = None
        if recv == self.group.rank:
            recv = None
        if send is not None:
            peer, t = send
            if peer not in self.meta_sent:
                self.meta_sent[peer] = (tuple(t.shape), t.dtype)
                ops.append(P2POp(isend, _meta(t).to(self.device),
                                 self._peer(peer), self.group))
            elif self.meta_sent[peer] != (tuple(t.shape), t.dtype):
                raise RuntimeError(
                    f"pipeline p2p: a message of {tuple(t.shape)} "
                    f"{t.dtype} to stage {peer} after "
                    f"{self.meta_sent[peer]}: every message between two "
                    f"stages must share one shape and dtype")
            ops.append(P2POp(isend, t, self._peer(send[0]), self.group))
            self.bytes += t.numel() * t.element_size()
            self.messages += 1
        buf = None
        if recv is not None:
            if recv not in self.meta_recv:
                # the send goes out before this rank blocks on the meta
                if ops:
                    self.pending += [(task, op.tensor) for task, op in
                                     zip(batch_isend_irecv(ops), ops)]
                    ops = []
                m = torch.zeros(_META_LEN, dtype=torch.int64,
                                device=self.device)
                self._wait(batch_isend_irecv(
                    [P2POp(irecv, m, self._peer(recv), self.group)])[0])
                m = m.cpu()
                self.meta_recv[recv] = (tuple(m[2:2 + int(m[0])].tolist()),
                                        _DTYPES[int(m[1])])
            shape, dtype = self.meta_recv[recv]
            buf = torch.empty(shape, dtype=dtype, device=self.device)
            ops.append(P2POp(irecv, buf, self._peer(recv), self.group))
        if not ops:
            return None
        tasks = batch_isend_irecv(ops)
        n_send = len(ops) - (recv is not None)
        self.pending += [(task, op.tensor)
                         for task, op in zip(tasks[:n_send], ops[:n_send])]
        return (tasks[-1], buf) if recv is not None else None

    def _wait(self, task):
        if not self.timed:
            task.wait()
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        task.wait()
        self.wait_s += time.perf_counter() - t0

    def take(self, posted):
        if posted is None:
            return self.local.popleft()
        task, buf = posted
        self._wait(task)
        return buf

    def drain(self):
        for task, _ in self.pending:
            task.wait()
        self.pending = []


def run_schedule(stage_fn, instructions, microbatches=None, labels=None,
                 loss_fn=None, *, group, num_chunks=1, loss_weights=None,
                 device=None, forward_only=False, keep_outputs=False,
                 timed=False):
    """Run this rank's ``instructions`` (a 1F1B or interleaved list) over
    the pp ``group``.

    stage_fn(chunk, x) -> y runs this rank's chunk ``chunk`` forward; on
        virtual stage 0, x is ``microbatches[m]`` (only rank 0 passes
        them); elsewhere the activation the previous stage sent.
    labels, loss_fn: on the last stage, loss_fn(y, labels[m]) is
        microbatch m's loss; it is multiplied by ``loss_weights[m]``
        (default 1 / M) before its backward, so the weighted losses sum
        to the batch's.
    forward_only: run the F instructions alone, without autograd.
    keep_outputs: keep the last stage's outputs (detached).

    Returns {"losses": [weighted loss, detached] (last stage), "outputs":
    [y] (last stage, keep_outputs), "stats": {"p2p_bytes",
    "p2p_messages", "recv_wait_s", "instructions", "seconds"}};
    ``recv_wait_s`` is time blocked in receives, measured after the device
    finished its queued work when ``timed``. The caller's gradients
    accumulate in the stage's parameters.
    """
    S, s, V = group.nranks, group.rank, int(num_chunks)
    instrs = [i for i in instructions if i.kind == "F"] if forward_only \
        else list(instructions)
    if not instrs:
        raise ValueError("an empty instruction list")
    M = 1 + max(i.microbatch for i in instrs)
    last = S * V - 1
    if loss_weights is None:
        loss_weights = [1.0 / M] * M
    if device is None:
        device = torch.device("cpu")
    if S * V > 1 and not forward_only:
        lists = [schedule_instructions(S, M, V, r) for r in range(S)]
        if lists[s] == instrs:
            _check_order(S, V, lists)
    wire = _Wire(group, device, timed)

    def need(ins):
        """The stage this instruction receives from, or None."""
        v = ins.chunk * S + s
        if ins.kind == "F":
            return (s - 1) % S if v > 0 else None
        return (s + 1) % S if v < last else None

    t0 = time.perf_counter()
    posted = wire.post(recv=need(instrs[0]))
    saved = {}
    losses, outputs = [], []
    for i, ins in enumerate(instrs):
        m, c = ins.microbatch, ins.chunk
        v = c * S + s
        out = None
        if ins.kind == "F":
            if v == 0:
                x = microbatches[m]
            else:
                x = wire.take(posted)
                if not forward_only and x.is_floating_point():
                    x.requires_grad_()
            with torch.set_grad_enabled(not forward_only):
                y = stage_fn(c, x)
                if v == last:
                    if keep_outputs:
                        outputs.append(y.detach())
                    if loss_fn is not None:
                        loss = loss_fn(y, labels[m]) * loss_weights[m]
                        losses.append(loss.detach())
                        y = loss
                else:
                    out = ((s + 1) % S, y.detach())
            if not forward_only:
                saved[(m, c)] = (x, y)
        else:
            x, y = saved.pop((m, c))
            if v == last:
                torch.autograd.backward(y)
            else:
                torch.autograd.backward(y, wire.take(posted))
            if v > 0:
                out = ((s - 1) % S, x.grad)
            del x, y
        nxt = need(instrs[i + 1]) if i + 1 < len(instrs) else None
        posted = wire.post(send=out, recv=nxt)
    wire.drain()
    stats = {"p2p_bytes": wire.bytes, "p2p_messages": wire.messages,
             "recv_wait_s": wire.wait_s, "instructions": len(instrs),
             "seconds": time.perf_counter() - t0}
    return {"losses": losses, "outputs": outputs, "stats": stats}


def broadcast_from_last(t, group, shape=None, dtype=None, device=None):
    """The last stage's tensor ``t`` on every rank of the pp group (the
    reference's psum of the last stage's outputs); other ranks pass None
    with its ``shape`` and ``dtype``, or None to receive them first."""
    if group.nranks == 1:
        return t
    src = group.ranks[-1]
    if shape is None:
        from ...misc import broadcast_object_list
        box = [None if t is None else (tuple(t.shape), t.dtype)]
        broadcast_object_list(box, src=src, group=group)
        shape, dtype = box[0]
    if t is None:
        t = torch.empty(shape, dtype=dtype, device=device)
    else:
        t = t.contiguous()
    broadcast(t, src=src, group=group)
    return t


def _stack_runner(stage_fn, stage_params, microbatches, group, V, device):
    S, s = group.nranks, group.rank
    M = microbatches.shape[0]
    instrs = [i for i in schedule_instructions(S, M, V, s) if i.kind == "F"]
    chunks = stage_params if V > 1 else [stage_params]
    res = run_schedule(lambda c, x: stage_fn(chunks[c], x), instrs,
                       list(microbatches) if s == 0 else None, group=group,
                       num_chunks=V, forward_only=True, keep_outputs=True,
                       device=device or microbatches.device)
    out = torch.stack(res["outputs"]) if s == S - 1 else None
    return broadcast_from_last(out, group, microbatches.shape,
                               microbatches.dtype, microbatches.device)


def _pp_group(group):
    if group is not None:
        return group
    from ..fleet import fleet
    hcg = fleet.get_hybrid_communicate_group()
    if hcg is None:
        raise ValueError("a pipeline needs fleet.init with a pp topology "
                         "(or group=)")
    return hcg.get_pipe_parallel_group()


def spmd_pipeline(stage_fn, stacked_params, microbatches, mesh=None,
                  axis="pp", *, group=None, device=None):
    """Run ``y = stage_S-1(...stage_0(x))`` for each microbatch, pipelined
    over the pp group; returns the last stage's outputs [M, mb, ...] on
    every rank. As the reference, stage_fn(params, x) -> y keeps x's
    shape. The port's difference: ``stacked_params`` is THIS rank's stage
    params (the reference takes all stages stacked and sharded over the
    mesh), and ``mesh`` / ``axis`` give way to ``group`` (fleet's pp group
    by default). Forward only: the training path is ``run_schedule``."""
    if mesh is not None:
        raise NotImplementedError("spmd_pipeline(mesh=...): the port runs "
                                  "over a process group (group=)")
    with torch.no_grad():
        return _stack_runner(stage_fn, stacked_params, microbatches,
                             _pp_group(group), 1, device)


def spmd_pipeline_interleaved(stage_fn, stacked_params, microbatches,
                              num_chunks, mesh=None, axis="pp", *,
                              group=None, device=None):
    """The interleaved (virtual-pipeline) counterpart of spmd_pipeline:
    ``stacked_params`` is this rank's list of ``num_chunks`` chunk params,
    chunk c of stage s being virtual stage c S + s, as the reference's
    layout; M must be a multiple of S (the reference pads instead)."""
    if mesh is not None:
        raise NotImplementedError("spmd_pipeline_interleaved(mesh=...): the "
                                  "port runs over a process group (group=)")
    if len(stacked_params) != int(num_chunks):
        raise ValueError(f"{len(stacked_params)} chunk params for "
                         f"num_chunks={num_chunks}")
    with torch.no_grad():
        return _stack_runner(stage_fn, stacked_params, microbatches,
                             _pp_group(group), int(num_chunks), device)
