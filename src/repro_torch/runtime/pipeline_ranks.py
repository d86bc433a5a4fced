"""Pipeline-parallel inference across processes, one stage a rank: the
counterpart of the JAX package's shard_map executor
(``repro/runtime/pipeline.py:181-292``), where ``spawn_stages`` takes the
place of ``make_pipeline_mesh``, ``stage_slice`` of the ``P("stage")``
in-spec, and ``RankPipelineForward`` of the stage body and its ``ppermute``.

Rank ``i`` walks stage ``i``'s LD, CP and ST programs with the walker of the
one-card executor (``pipeline.walk_stage``): the prologue, then one round a
microbatch. The paper's ISU tokens become point-to-point messages
(``torch.distributed`` isend / irecv) between neighbouring ranks:

- REQ ``i -> i+1``, BID b is the boundary activation itself. ST's DataMove
  copies the stage output into send buffer SB[b] (b from its AddrCyc);
  SEND_REQ sends SB[b] behind a header of ``HEADER`` int64s (round, BID, the
  time it was posted); WAIT_REQ receives into RB[b] and raises if the header
  carries another BID than the one the program waits on; LD's DataMove copies
  RB[b] into the stage input.
- ACK ``i+1 -> i``, BID b is a one-element message holding b, sent only once
  the copy out of RB[b] has completed: the buffer has been consumed. The two
  prologue SEND_ACKs pre-authorize B0 and B1; WAIT_ACK blocks until the
  consumer has released SB[b]. The ACKs that the producer's programs never
  wait for (the last two of a call) are received when the call ends, so that
  no message is left in flight between calls.
- A WAIT whose message does not come within ``wait_timeout_s`` raises,
  naming the token.

The process group's backend picks the transport; nothing switches on
failure:

- gloo, the host transport. gloo reads a tensor's memory from the host, so SB
  and RB are host buffers (pinned when the stage runs on a card) and the
  stage input lies on the rank's device. Each DataMove synchronizes its copy
  on the host: the D2H copy into SB[b] is complete before the isend, and the
  H2D copy out of RB[b] before the ACK. It is the transport that runs several
  ranks on one card.
- nccl, the device transport: SB and RB live on the rank's card, one card a
  rank, and the card's stream orders the copies against the messages. NCCL
  runs the point-to-point operations of a communicator in order, so REQs and
  ACKs travel in two process groups of their own: each carries one kind of
  message between a pair, which both sides post in the same order. NCCL ignores
  tags; the header check catches a BID mix-up all the same.
"""
from __future__ import annotations

import os
import queue
import tempfile
import threading
import time
import traceback
from datetime import timedelta
from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .._device import resolve_device
from ..configs.base import ArchConfig
from ..core.isa import Group, Sync
from ..models import transformer as tf
from ..models.layers import embed
from ..tree import tree_leaves, tree_map
from .pipeline import (SYNC_OPS, PipelinePlan, _check_uniform_dense, check_programs,
                       program_sync_counts, walk_stage)

HEADER = 3  # int64s ahead of a REQ's payload: round, BID, the ns it was posted at
_POLL_S = (2e-5, 1e-3)  # an NCCL WAIT's first and longest pause between polls


# ------------------------------------------------------------------ ranks --
class PerRank(list):
    """An argument of ``spawn_stages`` that differs by rank: rank ``r`` gets
    item ``r`` alone, never the others' (a rank's slice of the params)."""


def _rank_main(rank, n, backend, init_method, device, fn, box, results, release,
               timeout_s) -> None:
    args = box.pop()  # the only reference: the arguments (CUDA IPC) go with the call
    try:
        if device.type == "cuda":
            torch.cuda.set_device(device)
        else:
            torch.set_num_threads(1)  # the ranks share the host's cores
        dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=n,
                                timeout=timedelta(seconds=timeout_s))
        out = (rank, None, fn(rank, device, *args))
    except Exception:  # reported to the caller, traceback and all
        out = (rank, traceback.format_exc(), None)
    del args  # a tensor shared by CUDA IPC is handed back before the process ends
    results.put(out)
    # keep this rank's connections open until every rank has reported: a peer
    # still waiting on it fails by its own timeout, not by a closed connection
    release.wait(timeout_s)
    if out[1] is not None:
        os._exit(1)  # a WAIT of the failed call may still block inside the transport
    dist.destroy_process_group()


def spawn_stages(n_stages: int, fn: Callable, *args, backend: str = "gloo", device=None,
                 timeout_s: float = 600.0) -> list:
    """Run ``fn(rank, device, *args)`` in ``n_stages`` processes, one stage a
    rank, and return what each rank returned, in rank order: the counterpart
    of ``make_pipeline_mesh`` (``repro/runtime/pipeline.py:182-183``).

    The processes start with the spawn method (``fn`` and the arguments are
    pickled; CUDA tensors travel by CUDA IPC, CPU tensors through shared
    memory) and join a process group of ``backend`` through a file in a fresh
    temporary directory, so concurrent calls never collide on a port. An
    argument wrapped in ``PerRank`` gives rank r its item r. ``device`` None
    means the card: with gloo every rank runs on it, with nccl rank r takes
    ``cuda:r``; ``"cpu"`` runs every rank on the CPU with one thread. ``fn``
    should return host objects (numbers, CPU tensors).

    If a rank raises, the call raises ``RuntimeError`` with the traceback of
    every rank that failed, in rank order, once every rank has reported. A
    call still running after ``timeout_s`` terminates every rank and raises
    ``TimeoutError``."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend {backend!r}: the stages run over gloo or nccl")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError(f"nccl runs on cards, not on {dev}; gloo runs on the CPU")
        if torch.cuda.device_count() < n_stages:
            raise ValueError(f"nccl takes one card a rank: {n_stages} ranks, "
                             f"{torch.cuda.device_count()} cards; gloo runs several ranks "
                             "on one card")
        devices = [torch.device("cuda", r) for r in range(n_stages)]
    else:
        devices = [dev] * n_stages
    for a in args:
        if isinstance(a, PerRank) and len(a) != n_stages:
            raise ValueError(f"a PerRank argument of {len(a)} items for {n_stages} ranks")

    ctx = mp.get_context("spawn")
    results, release = ctx.Queue(), ctx.Event()
    got: dict[int, tuple] = {}
    with tempfile.TemporaryDirectory(prefix="stages-") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = []
        for r in range(n_stages):
            rank_args = tuple(a[r] if isinstance(a, PerRank) else a for a in args)
            procs.append(ctx.Process(target=_rank_main, name=f"stage{r}", daemon=True, args=(
                r, n_stages, backend, init, devices[r], fn, [rank_args], results, release,
                timeout_s)))
        try:
            for p in procs:
                p.start()
            deadline = time.monotonic() + timeout_s
            while len(got) < n_stages:
                left = deadline - time.monotonic()
                if left <= 0:
                    missing = [r for r in range(n_stages) if r not in got]
                    raise TimeoutError(f"ranks {missing} of {n_stages} still running after "
                                       f"{timeout_s:g} s; every rank terminated")
                try:
                    rank, err, out = results.get(timeout=min(left, 1.0))
                    got[rank] = (err, out)
                except queue.Empty:
                    for r, p in enumerate(procs):  # a rank that died without reporting
                        if r not in got and p.exitcode is not None:
                            got[r] = (f"exited with code {p.exitcode} before reporting", None)
        finally:
            release.set()
            for p in procs:
                p.join(5)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(5)
    failed = [f"rank {r}: {err}" for r, (err, _) in sorted(got.items()) if err]
    if failed:
        raise RuntimeError(f"{len(failed)} of {n_stages} ranks failed\n" + "\n".join(failed))
    return [got[r][1] for r in range(n_stages)]


def stage_slice(cfg: ArchConfig, stage_params: dict, plan: PipelinePlan, rank: int) -> dict:
    """Rank ``rank``'s params, the counterpart of the ``P("stage")`` in-spec:
    its stage's ``(lps, ...)`` block leaves (views of ``stage_params``'s, as
    ``stack_stage_params`` gives them), plus ``embed`` on the first rank and
    ``final_norm`` and the head (``embed`` or ``lm_head``) on the last. No
    rank holds the whole model."""
    _check_uniform_dense(cfg)
    S = plan.n_stages
    if not 0 <= rank < S:
        raise ValueError(f"rank {rank} of {S} stages")
    blocks = stage_params["blocks"][0]
    for leaf in tree_leaves(blocks):
        if leaf.shape[:2] != (S, plan.layers_per_stage):
            raise ValueError(f"block leaf {tuple(leaf.shape)}: want (S, lps) = "
                             f"({S}, {plan.layers_per_stage}) first; restack with "
                             "stack_stage_params")
    out = {"blocks": [tree_map(lambda x: x[rank], blocks)]}
    if rank == 0:
        out["embed"] = stage_params["embed"]
    if rank == S - 1:
        head = "embed" if cfg.tie_embeddings else "lm_head"
        out["final_norm"], out[head] = stage_params["final_norm"], stage_params[head]
    return out


# --------------------------------------------------------------- messages --
def _wait(work, failed: list) -> None:
    try:
        work.wait()
    except Exception as e:  # handed to the thread that waits for this one
        failed.append(e)


class _Messages:
    """The boundary buffers of one rank and the token messages over them:
    SB[0], SB[1] towards rank + 1, RB[0], RB[1] from rank - 1, each a byte
    buffer of ``HEADER`` int64s and the payload; ``host`` picks the transport
    (host buffers, copies synchronized on the host) or the device one."""

    def __init__(self, rank: int, n: int, shape: tuple, dtype: torch.dtype,
                 device: torch.device, host: bool, groups: tuple, timeout_s: float):
        self.rank, self.host, self.timeout_s = rank, host, timeout_s
        self.key = (shape, dtype, device)
        self.cuda = device.type == "cuda"
        self.buf_dev = torch.device("cpu") if host else device
        self.req_group, self.ack_group = groups
        nbytes = HEADER * 8 + torch.Size(shape).numel() * dtype.itemsize

        def buffers(present: bool):
            if not present:
                return []
            bufs = [torch.empty(nbytes, dtype=torch.uint8, device=self.buf_dev,
                                pin_memory=host and self.cuda) for _ in range(2)]
            return [(b[:HEADER * 8].view(torch.int64), b[HEADER * 8:].view(dtype).view(shape), b)
                    for b in bufs]

        self.sb, self.rb = buffers(rank < n - 1), buffers(rank > 0)
        self.sending: list[Optional[tuple]] = [None, None]  # the isend of SB[b] in flight
        self.acks: list[tuple] = []  # ACK isends in flight, with their tensors
        self.messages: list[tuple[str, int, float]] = []

    # -- waiting, with the timeout --------------------------------------------
    def _await(self, work, what: str) -> int:
        """Wait for ``work`` at most the timeout; the host time (ns) it
        completed at. gloo completes an operation only inside ``wait()``, and
        a ``wait(timeout)`` that expires closes the connection under the
        peer, so the wait runs in a thread of its own, bounded here; an NCCL
        operation completes on its stream and is polled."""
        if self.host:
            failed: list[BaseException] = []
            waiter = threading.Thread(target=_wait, args=(work, failed), daemon=True)
            waiter.start()
            waiter.join(self.timeout_s)
            if waiter.is_alive():
                raise RuntimeError(f"{what} timed out after {self.timeout_s:g} s")
            if failed:
                raise RuntimeError(f"{what} failed: {failed[0]}") from failed[0]
            return time.monotonic_ns()
        deadline = time.monotonic() + self.timeout_s
        pause = _POLL_S[0]
        while not work.is_completed():
            if time.monotonic() > deadline:
                raise RuntimeError(f"{what} timed out after {self.timeout_s:g} s")
            time.sleep(pause)
            pause = min(2 * pause, _POLL_S[1])
        done = time.monotonic_ns()
        work.wait()  # raises what NCCL raised; orders the current stream after it
        return done

    def _copy(self, dst: torch.Tensor, src: torch.Tensor) -> float:
        """The host transport's copy between the card and a host buffer,
        complete on return; its ms: on a card the copy's device time (CUDA
        events, which leave out the stage's work queued before it), on the
        CPU the host clock."""
        if not self.cuda:
            t0 = time.perf_counter()
            dst.copy_(src)
            return (time.perf_counter() - t0) * 1e3
        ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev[0].record()
        dst.copy_(src, non_blocking=True)
        ev[1].record()
        ev[1].synchronize()
        return ev[0].elapsed_time(ev[1])

    # -- DataMoves ------------------------------------------------------------
    def put(self, b: int, h: torch.Tensor, r: int) -> None:
        """ST: the stage output into SB[b], once SB[b]'s last isend is done."""
        payload = self.sb[b][1]
        if self.sending[b] is not None:
            self._await(self.sending[b][0], f"the isend of SB[{b}]")
            self.sending[b] = None
        if h.dtype != payload.dtype or h.shape != payload.shape:
            raise ValueError(f"stage output {h.dtype} {tuple(h.shape)}, the boundary "
                             f"carries {payload.dtype} {tuple(payload.shape)}")
        if self.host:  # gloo must not read SB[b] before the copy is done
            self.messages.append(("d2h", r, self._copy(payload, h)))
        else:
            payload.copy_(h)

    def take(self, b: int, inbuf: torch.Tensor, r: int) -> torch.Tensor:
        """LD: RB[b] into the stage input; on the host transport the copy has
        completed when this returns, so the next SEND_ACK finds RB[b] free."""
        if self.host:
            self.messages.append(("h2d", r, self._copy(inbuf, self.rb[b][1])))
        else:
            inbuf.copy_(self.rb[b][1])
        return inbuf

    # -- Syncs ----------------------------------------------------------------
    def send_req(self, dst: int, b: int, r: int) -> None:
        hdr, _, whole = self.sb[b]
        hdr.copy_(torch.tensor([r, b, time.monotonic_ns()], dtype=torch.int64))
        self.sending[b] = (dist.isend(whole, dst, group=self.req_group), whole)

    def wait_req(self, src: int, b: int, r: int) -> None:
        hdr, _, whole = self.rb[b]
        name = f"REQ {src}->{self.rank}"
        posted = time.monotonic_ns()
        done = self._await(dist.irecv(whole, src, group=self.req_group),
                           f"WAIT on {name} B{b}")
        got_r, got_b, sent = hdr.tolist()
        if got_b != b:
            raise RuntimeError(f"{name} carried B{got_b}, the program waits on B{b}")
        if got_r != r:
            raise RuntimeError(f"{name} B{b} carried round {got_r}, the program is in round {r}")
        self.messages.append(("send_recv", r, (done - max(posted, sent)) / 1e6))

    def send_ack(self, dst: int, b: int) -> None:
        ack = torch.tensor([b], dtype=torch.int64, device=self.buf_dev)
        self.acks.append((dist.isend(ack, dst, group=self.ack_group), ack))

    def wait_ack(self, src: int, b: Optional[int]) -> None:
        """WAIT_ACK on BID b; ``b`` None receives an ACK the programs left."""
        ack = torch.empty(1, dtype=torch.int64, device=self.buf_dev)
        name = f"ACK {src}->{self.rank}"
        self._await(dist.irecv(ack, src, group=self.ack_group),
                    f"WAIT on {name}" + ("" if b is None else f" B{b}"))
        got = int(ack.item())
        if b is not None and got != b:
            raise RuntimeError(f"{name} carried B{got}, the program waits on B{b}")

    def finish(self, acks_left: int) -> None:
        """End of a call: receive the ACKs no WAIT_ACK took, then see every
        isend of this rank through, so that nothing is in flight."""
        for _ in range(acks_left):
            self.wait_ack(self.rank + 1, None)
        for b, sending in enumerate(self.sending):
            if sending is not None:
                self._await(sending[0], f"the isend of SB[{b}]")
        for work, _ in self.acks:
            self._await(work, "an ACK's isend")
        self.sending, self.acks = [None, None], []


# --------------------------------------------------------------- executor --
class RankPipelineForward:
    """One rank's part of the pipelined forward: ``fn(local_params, tokens
    (M, mb, s))`` runs stage ``rank``'s programs and returns, on the last
    rank, the logits ``(M, mb, s, V)`` fp32 that ``PipelineForward`` returns,
    None on the others. ``local_params`` is ``stage_slice(..., rank)``;
    stage i runs layers ``i * lps ... min((i + 1) * lps, L)``, the split of
    the JAX stage body (``layer_base = stage_id * lps``).

    The default process group holds one rank a stage; its backend picks the
    transport (module docstring). After a call, ``counts`` holds the token
    operations this rank performed (by name, ``SYNC_OPS``), ``stage_ms`` the
    device time of its Compute instruction in each round (on the card), and
    ``messages`` a ``(what, round, ms)`` for each boundary message this rank
    handled: ``"d2h"``, the copy into SB, and ``"h2d"``, the copy out of RB
    (the host transport's; CUDA events on a card, the host clock on the
    CPU); ``"send_recv"``, on the host clock, from the later of the isend's
    and the irecv's posting to the payload in RB."""

    def __init__(self, cfg: ArchConfig, plan: PipelinePlan, rank: int, device=None, *,
                 wait_timeout_s: float = 300.0):
        _check_uniform_dense(cfg)
        check_programs(plan)
        self.device = resolve_device(device)
        if not dist.is_initialized():
            raise RuntimeError("no process group: start the ranks with spawn_stages")
        if (dist.get_world_size(), dist.get_rank()) != (plan.n_stages, rank):
            raise ValueError(f"rank {rank} of {plan.n_stages} stages, but the process group "
                             f"has rank {dist.get_rank()} of {dist.get_world_size()}")
        self.backend = dist.get_backend()
        if self.backend not in ("gloo", "nccl"):
            raise ValueError(f"backend {self.backend!r}: the executor takes gloo (the host "
                             "transport) or nccl (the device transport)")
        self.cfg, self.plan, self.rank = cfg, plan, rank
        if self.backend == "nccl" and self.device.type != "cuda":
            raise ValueError("the nccl transport runs on cards; gloo runs on the CPU")
        self.wait_timeout_s = wait_timeout_s
        # nccl: a process group for each kind of message, so that each
        # communicator carries one kind between a pair, posted in the same
        # order on both sides (a collective: every rank builds its executor)
        self._groups = ((None, None) if self.backend == "gloo"
                        else (dist.new_group(), dist.new_group()))
        want = program_sync_counts(plan)
        # the ACKs the next stage sends that this one never waits for
        self.acks_left = (want[rank + 1]["SEND_ACK"] - want[rank]["WAIT_ACK"]
                          if rank < plan.n_stages - 1 else 0)
        self._msgs: Optional[_Messages] = None
        self.counts: dict[str, int] = {}
        self.stage_ms: list[float] = []
        self.messages: list[tuple[str, int, float]] = []

    def __call__(self, local_params: dict, tokens: torch.Tensor) -> Optional[torch.Tensor]:
        cfg, plan, rank = self.cfg, self.plan, self.rank
        S, M, lps, L = plan.n_stages, plan.microbatches, plan.layers_per_stage, cfg.num_layers
        first, last = rank == 0, rank == S - 1
        if tokens.dim() != 3 or tokens.shape[0] != M:
            raise ValueError(f"want tokens (M, mb, s) with M = {M}; got {tuple(tokens.shape)}")
        if tokens.device.type != self.device.type:
            raise ValueError(f"tokens on {tokens.device}, the executor runs on {self.device}")
        dev = tokens.device
        cuda = dev.type == "cuda"
        mb, s = tokens.shape[1], tokens.shape[2]
        layers = local_params["blocks"][0]
        dtype = tree_leaves(layers)[0].dtype
        shape = (mb, s, cfg.d_model)
        msgs = self._msgs  # the buffers stay from call to call at one shape
        if msgs is None or msgs.key != (shape, dtype, dev):
            msgs = self._msgs = _Messages(rank, S, shape, dtype, dev, self.backend == "gloo",
                                          self._groups, self.wait_timeout_s)
        msgs.messages = []
        inbuf = None if first else torch.empty(shape, dtype=dtype, device=dev)
        logits = (torch.empty((M, mb, s, cfg.vocab_size), dtype=torch.float32, device=dev)
                  if last else None)
        n_local = max(0, min(lps, L - rank * lps))
        counts = dict.fromkeys(SYNC_OPS, 0)
        events: list[tuple] = []
        pu = plan.programs[rank].clone()  # dynamic state is rewritten per round
        h: Optional[torch.Tensor] = None
        r = 0

        def sync(inst: Sync) -> None:
            if inst.kind == "req":
                (msgs.send_req if inst.is_send else msgs.wait_req)(inst.pid, inst.bid, r)
            elif inst.is_send:
                msgs.send_ack(inst.pid, inst.bid)
            else:
                msgs.wait_ack(inst.pid, inst.bid)

        def move(group: Group, b: int) -> None:
            nonlocal h
            if group == Group.LD:  # take microbatch r in
                h = embed(local_params["embed"], tokens[r]) if first else msgs.take(b, inbuf, r)
            elif last:  # hand it on: the last stage writes the logits
                logits[r].copy_(tf.final_logits(cfg, local_params, h).float())
            else:
                msgs.put(b, h, r)

        def compute() -> None:
            nonlocal h
            if cuda:
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                ev[0].record()
            h = tf.forward_layers(cfg, layers, 0, n_local, h)
            if cuda:
                ev[1].record()
                events.append(ev)

        walk_stage(pu, True, counts, sync=sync, move=move, compute=compute)
        for r in range(M):
            walk_stage(pu, False, counts, sync=sync, move=move, compute=compute)
        msgs.finish(self.acks_left)
        if cuda:
            torch.cuda.synchronize(dev)
        self.counts = counts
        self.stage_ms = [a.elapsed_time(b) for a, b in events]
        self.messages = msgs.messages
        return logits


def forward_rank(rank: int, device: torch.device, cfg: ArchConfig, plan: PipelinePlan,
                 local_params: dict, tokens: torch.Tensor, wait_timeout_s: float = 300.0) -> dict:
    """A rank body for ``spawn_stages``: one call of this rank's
    ``RankPipelineForward`` on ``local_params`` and ``tokens`` moved to
    ``device``. Returns the logits (on the CPU, the last rank only; None on
    the others), ``counts``, ``stage_ms`` and ``messages``."""
    fn = RankPipelineForward(cfg, plan, rank, device, wait_timeout_s=wait_timeout_s)
    out = fn(tree_map(lambda x: x.to(device), local_params), tokens.to(device))
    return {"logits": None if out is None else out.cpu(), "counts": fn.counts,
            "stage_ms": fn.stage_ms, "messages": fn.messages}
