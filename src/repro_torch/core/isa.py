"""Custom ISA for instruction-based multi-PU coordination (paper Table I).

Six instruction types organized into three ICU groups (Load, Compute, Store):

  ProgCtrl  PRG_PRM        -- program loop control; NR rounds, ICU_BA jump base
  Config    *_PRM          -- stride / IM2COL / URAM addressing parameters
  DataMove  *_ADM          -- AXI DataMover transfers; CUR_BA latched for a
                              successor AddrCyc
  AddrCyc   CYCLE_ADDR     -- cyclic addressing (BA, AOFFS, NC, IC) with
                              write-back to the *predecessor* DataMove CUR_BA
            CYCLE_LEN      -- the length-advance mode of the AddrCyc family
                              (:class:`AddrLen`): per-round LEN counter over a
                              cyclic append-only region (K/V caches of
                              autoregressive decode), written back to the
                              predecessor DataMove LEN
  Sync      SEND/WAIT_REQ/ACK -- peer-to-peer REQ/ACK coordination (BID,
                              DST/SRC_PID, BASE_BID, NC, IC) with BID cycling
  Compute   GEMM           -- systolic-array + vector ops (ReLU, scales,
                              residual add enable, rounds)

All instructions are 64-bit; every encoding carries OPCD (6b) and PRG_END (1b).
``ProgCtrl``, ``Config`` and ``Compute`` are *static*; ``DataMove`` (its
CUR_BA), ``AddrCyc`` and ``Sync`` are *dynamic* — their state is written back
into the ICU BRAM by the decoder (Table I(b) algorithms, implemented in
:meth:`AddrCyc.step` / :meth:`Sync.step`).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import ClassVar


class Group(enum.Enum):
    LD = "LD"
    CP = "CP"
    ST = "ST"


class Opcode(enum.IntEnum):
    # ProgCtrl
    PRG_PRM = 0x01
    # Config
    IM2COL_PRM = 0x04
    STRIDE_PRM = 0x05
    URAM_PRM = 0x06
    RES_ADD_STRIDE_PRM = 0x07
    # DataMove
    LINEAR_ADM = 0x10
    IM2COL_ADM = 0x11
    STRIDE_ADM = 0x12
    WEIGHTS_ADM = 0x13
    RES_ADD_ADM = 0x14
    RES_ADD_STRIDE_ADM = 0x15
    # AddrCyc family (address cycling + the length-advance mode)
    CYCLE_ADDR = 0x20
    CYCLE_LEN = 0x21
    # Sync
    SEND_REQ = 0x28
    SEND_ACK = 0x29
    WAIT_REQ = 0x2A
    WAIT_ACK = 0x2B
    # Compute
    GEMM = 0x30


# Which opcodes are legal in which ICU group (paper Table I(c)).
GROUP_OPCODES: dict[Group, frozenset[Opcode]] = {
    Group.LD: frozenset(
        {
            Opcode.LINEAR_ADM,
            Opcode.IM2COL_PRM,
            Opcode.IM2COL_ADM,
            Opcode.STRIDE_PRM,
            Opcode.STRIDE_ADM,
            Opcode.SEND_ACK,
            Opcode.WAIT_REQ,
            Opcode.CYCLE_ADDR,
            Opcode.CYCLE_LEN,
            Opcode.PRG_PRM,
        }
    ),
    Group.CP: frozenset(
        {
            Opcode.URAM_PRM,
            Opcode.WEIGHTS_ADM,
            Opcode.RES_ADD_STRIDE_PRM,
            Opcode.RES_ADD_STRIDE_ADM,
            Opcode.RES_ADD_ADM,
            Opcode.CYCLE_ADDR,
            Opcode.CYCLE_LEN,
            Opcode.GEMM,
            Opcode.PRG_PRM,
        }
    ),
    Group.ST: frozenset(
        {
            Opcode.LINEAR_ADM,
            Opcode.STRIDE_PRM,
            Opcode.STRIDE_ADM,
            Opcode.SEND_REQ,
            Opcode.WAIT_ACK,
            Opcode.CYCLE_ADDR,
            Opcode.CYCLE_LEN,
            Opcode.PRG_PRM,
        }
    ),
}

_SYNC_SEND = frozenset({Opcode.SEND_REQ, Opcode.SEND_ACK})
_SYNC_WAIT = frozenset({Opcode.WAIT_REQ, Opcode.WAIT_ACK})
SYNC_OPCODES = _SYNC_SEND | _SYNC_WAIT


def _check(value: int, bits: int, name: str) -> int:
    if not (0 <= value < (1 << bits)):
        raise ValueError(f"field {name}={value} does not fit in {bits} bits")
    return value


BEAT = 64  # HBM addresses/lengths are encoded in 64-byte AXI beats


def _to_beats(value: int, name: str, round_up: bool = False) -> int:
    if round_up:
        return (value + BEAT - 1) // BEAT
    if value % BEAT:
        raise ValueError(f"{name}={value} must be {BEAT}-byte aligned")
    return value // BEAT


class _Packer:
    """Sequential MSB-first bitfield packer for the 64-bit encoding."""

    def __init__(self) -> None:
        self.word = 0
        self.pos = 64

    def put(self, value: int, bits: int, name: str) -> "_Packer":
        _check(value, bits, name)
        self.pos -= bits
        if self.pos < 0:
            raise ValueError("instruction encoding exceeds 64 bits")
        self.word |= value << self.pos
        return self


class _Unpacker:
    def __init__(self, word: int) -> None:
        self.word = word
        self.pos = 64

    def get(self, bits: int) -> int:
        self.pos -= bits
        return (self.word >> self.pos) & ((1 << bits) - 1)


@dataclass
class Instruction:
    """Base: OPCD(6) | PRG_END(1) | type-specific payload."""

    opcode: ClassVar[Opcode]
    prg_end: bool = False

    @property
    def is_static(self) -> bool:
        return True

    def encode(self) -> int:
        p = _Packer()
        p.put(int(self.opcode), 6, "OPCD")
        p.put(int(self.prg_end), 1, "PRG_END")
        self._encode_payload(p)
        return p.word

    def _encode_payload(self, p: _Packer) -> None:  # pragma: no cover
        pass

    @staticmethod
    def decode(word: int) -> "Instruction":
        op = Opcode((word >> 58) & 0x3F)
        u = _Unpacker(word)
        u.get(6)
        prg_end = bool(u.get(1))
        cls = _DECODERS[op]
        inst = cls._decode_payload(op, u)
        inst.prg_end = prg_end
        return inst


@dataclass
class ProgCtrl(Instruction):
    """PRG_PRM: NR==0 -> infinite loop; else run NR rounds, jumping to ICU_BA
    at the end of each round (Table I(b))."""

    opcode: ClassVar[Opcode] = Opcode.PRG_PRM
    nr: int = 1  # number of rounds; 0 = infinite
    icu_ba: int = 0  # jump base address for rounds >= 2

    def _encode_payload(self, p: _Packer) -> None:
        p.put(self.nr, 24, "NR")
        p.put(self.icu_ba, 12, "ICU_BA")

    @classmethod
    def _decode_payload(cls, op: Opcode, u: _Unpacker) -> "ProgCtrl":
        return cls(nr=u.get(24), icu_ba=u.get(12))


@dataclass
class Config(Instruction):
    """*_PRM: establishes stride pattern / IM2COL / URAM context for the next
    DataMove. Payload packs (param0..param3) whose meaning depends on OPCD:

      STRIDE_PRM / RES_ADD_STRIDE_PRM: stride, burst_len, n_bursts, -
      IM2COL_PRM:                      kernel(4b k_h<<2|k_w? packed), stride,
                                       pad, in_w
      URAM_PRM:                        uram_addr, -, -, -
    """

    opcode: ClassVar[Opcode] = Opcode.STRIDE_PRM
    op: Opcode = Opcode.STRIDE_PRM
    param0: int = 0
    param1: int = 0
    param2: int = 0
    param3: int = 0

    def __post_init__(self) -> None:
        assert self.op in {
            Opcode.STRIDE_PRM,
            Opcode.IM2COL_PRM,
            Opcode.URAM_PRM,
            Opcode.RES_ADD_STRIDE_PRM,
        }

    def encode(self) -> int:
        p = _Packer()
        p.put(int(self.op), 6, "OPCD")
        p.put(int(self.prg_end), 1, "PRG_END")
        p.put(self.param0, 20, "param0")
        p.put(self.param1, 14, "param1")
        p.put(self.param2, 12, "param2")
        p.put(self.param3, 11, "param3")
        return p.word

    @classmethod
    def _decode_payload(cls, op: Opcode, u: _Unpacker) -> "Config":
        return cls(op=op, param0=u.get(20), param1=u.get(14), param2=u.get(12), param3=u.get(11))


@dataclass
class DataMove(Instruction):
    """*_ADM: drives one AXI DataMover transfer of LEN bytes at CUR_BA.

    CUR_BA is *latched* for an optional successor AddrCyc which rewrites it
    (dynamic behavior). ``buffer`` names the on-chip target/source buffer for
    the simulator ("act_in", "weights", "res", "act_out")."""

    opcode: ClassVar[Opcode] = Opcode.LINEAR_ADM
    op: Opcode = Opcode.LINEAR_ADM
    cur_ba: int = 0  # HBM byte address
    length: int = 0  # transfer bytes
    channel: int = 0  # HBM channel id (from liveness analysis)
    # Broadcast stores (a node with several output tensors): HOLD keeps the
    # output-buffer slot acquired across the node's remaining ST transfers —
    # they re-read the same slot — and only the final transfer (HOLD=0)
    # frees it back to the compute engine.
    hold: bool = False

    def __post_init__(self) -> None:
        assert self.op in {
            Opcode.LINEAR_ADM,
            Opcode.IM2COL_ADM,
            Opcode.STRIDE_ADM,
            Opcode.WEIGHTS_ADM,
            Opcode.RES_ADD_ADM,
            Opcode.RES_ADD_STRIDE_ADM,
        }

    @property
    def is_static(self) -> bool:
        return False  # CUR_BA is rewritten by successor AddrCyc

    def encode(self) -> int:
        p = _Packer()
        p.put(int(self.op), 6, "OPCD")
        p.put(int(self.prg_end), 1, "PRG_END")
        p.put(_to_beats(self.cur_ba, "CUR_BA"), 26, "CUR_BA")
        p.put(_to_beats(self.length, "LEN", round_up=True), 22, "LEN")
        p.put(self.channel, 5, "CHANNEL")
        p.put(int(self.hold), 1, "HOLD")
        return p.word

    @classmethod
    def _decode_payload(cls, op: Opcode, u: _Unpacker) -> "DataMove":
        return cls(op=op, cur_ba=u.get(26) * BEAT, length=u.get(22) * BEAT,
                   channel=u.get(5), hold=bool(u.get(1)))


@dataclass
class AddrCyc(Instruction):
    """CYCLE_ADDR: cyclic addressing over NC+1 regions (Table I(b)).

        if IC == 0: IC, CUR_BA = NC, BA
        else:       IC, CUR_BA = IC-1, CUR_BA + AOFFS

    Write-back: *predecessor* DataMove.cur_ba := CUR_BA (next round's address),
    own IC. NC=1 yields the two-region ping-pong used for B-buffers; NC=n-1
    cycles over n A/C-regions. IC initialises to NC when loaded offline.
    """

    opcode: ClassVar[Opcode] = Opcode.CYCLE_ADDR
    ba: int = 0
    aoffs: int = 0
    nc: int = 0
    ic: int = 0  # iteration counter; loaded as NC offline

    @property
    def is_static(self) -> bool:
        return False

    def step(self, pred_cur_ba: int) -> int:
        """Advance one program round; returns the new CUR_BA to write back
        into the predecessor DataMove."""
        if self.ic == 0:
            self.ic = self.nc
            new_ba = self.ba
        else:
            self.ic -= 1
            new_ba = pred_cur_ba + self.aoffs
        return new_ba

    def _encode_payload(self, p: _Packer) -> None:
        p.put(_to_beats(self.ba, "BA"), 26, "BA")
        p.put(_to_beats(self.aoffs, "AOFFS", round_up=True), 17, "AOFFS")
        p.put(self.nc, 7, "NC")
        p.put(self.ic, 7, "IC")

    @classmethod
    def _decode_payload(cls, op: Opcode, u: _Unpacker) -> "AddrCyc":
        return cls(ba=u.get(26) * BEAT, aoffs=u.get(17) * BEAT, nc=u.get(7), ic=u.get(7))


@dataclass
class AddrLen(Instruction):
    """CYCLE_LEN: the length-advance mode of the AddrCyc family.

        if IC == 0: IC, CUR_LEN = NC, LEN_BASE
        else:       IC, CUR_LEN = IC-1, CUR_LEN + LOFFS

    Write-back: *predecessor* DataMove.length := CUR_LEN (next round's
    transfer length), own IC. This drives transfers over an *append-only*
    cyclic region whose valid prefix grows every program round — the K/V
    cache of autoregressive decode: round r of a decode window reads
    LEN_BASE + r*LOFFS bytes, then the counter wraps for the next sequence.
    IC initialises to NC when loaded offline, exactly like AddrCyc.
    """

    opcode: ClassVar[Opcode] = Opcode.CYCLE_LEN
    len_base: int = 0  # bytes of the first round's transfer
    loffs: int = 0  # bytes appended per round
    nc: int = 0
    ic: int = 0  # iteration counter; loaded as NC offline

    @property
    def is_static(self) -> bool:
        return False

    def step(self, pred_length: int) -> int:
        """Advance one program round; returns the new LEN to write back into
        the predecessor DataMove."""
        if self.ic == 0:
            self.ic = self.nc
            new_len = self.len_base
        else:
            self.ic -= 1
            new_len = pred_length + self.loffs
        return new_len

    def _encode_payload(self, p: _Packer) -> None:
        p.put(_to_beats(self.len_base, "LEN_BASE", round_up=True), 22, "LEN_BASE")
        p.put(_to_beats(self.loffs, "LOFFS", round_up=True), 17, "LOFFS")
        p.put(self.nc, 9, "NC")
        p.put(self.ic, 9, "IC")

    @classmethod
    def _decode_payload(cls, op: Opcode, u: _Unpacker) -> "AddrLen":
        return cls(len_base=u.get(22) * BEAT, loffs=u.get(17) * BEAT,
                   nc=u.get(9), ic=u.get(9))


@dataclass
class Sync(Instruction):
    """SEND_REQ / SEND_ACK / WAIT_REQ / WAIT_ACK (Table I(b)).

    BID cycling across program rounds:

        if NC == 0:  BID = BID              (bypass)
        elif IC == 0: BID, IC = BASE_BID, NC (reset)
        else:        BID, IC = BID+1, IC-1   (increment)

    SEND_* transmit a control token to PU ``pid`` (DST_PID); WAIT_* poll the
    REQ/ACK LUTRAM for a token from PU ``pid`` (SRC_PID) with buffer id BID,
    then clear the entry. IC initialises to NC when loaded offline.
    """

    opcode: ClassVar[Opcode] = Opcode.SEND_REQ
    op: Opcode = Opcode.SEND_REQ
    pid: int = 0  # DST_PID for SEND_*, SRC_PID for WAIT_*
    bid: int = 0
    base_bid: int = 0
    nc: int = 0
    ic: int = 0

    def __post_init__(self) -> None:
        assert self.op in SYNC_OPCODES

    @property
    def is_static(self) -> bool:
        return False

    @property
    def is_send(self) -> bool:
        return self.op in _SYNC_SEND

    @property
    def kind(self) -> str:
        """'req' or 'ack' -- which LUTRAM this instruction touches."""
        return "req" if self.op in (Opcode.SEND_REQ, Opcode.WAIT_REQ) else "ack"

    def step(self) -> None:
        """Advance BID state one program round (after the token action)."""
        if self.nc == 0:
            return  # bypass
        if self.ic == 0:
            self.bid, self.ic = self.base_bid, self.nc
        else:
            self.bid, self.ic = self.bid + 1, self.ic - 1

    def encode(self) -> int:
        p = _Packer()
        p.put(int(self.op), 6, "OPCD")
        p.put(int(self.prg_end), 1, "PRG_END")
        p.put(self.pid, 6, "PID")
        p.put(self.bid, 12, "BID")
        p.put(self.base_bid, 12, "BASE_BID")
        p.put(self.nc, 12, "NC")
        p.put(self.ic, 12, "IC")
        return p.word

    @classmethod
    def _decode_payload(cls, op: Opcode, u: _Unpacker) -> "Sync":
        return cls(op=op, pid=u.get(6), bid=u.get(12), base_bid=u.get(12), nc=u.get(12), ic=u.get(12))


@dataclass
class Compute(Instruction):
    """GEMM: drives the systolic array + vector post-processing.

    m/n/k give the GEMM dims for this node tile set (out-ch, spatial, in-dim);
    scale_shift is the power-of-two requantization shift; relu/add_enable
    configure the post-processing block; rounds is the number of SA waves;
    wchunks is the number of dynamically-streamed weight chunks this GEMM
    consumes (the URAM read interlock of the SMOF-style weight streaming —
    the decoder blocks the GEMM until that many preceding WEIGHTS_ADM
    transfers have landed in URAM).
    """

    opcode: ClassVar[Opcode] = Opcode.GEMM
    m: int = 0
    n: int = 0
    k: int = 0
    relu: bool = False
    add_enable: bool = False  # fused residual shortcut addition
    scale_shift: int = 0  # right-shift amount (po2 scale)
    rounds: int = 1
    wchunks: int = 0  # streamed weight chunks consumed (0 = fully preloaded)

    def _encode_payload(self, p: _Packer) -> None:
        p.put(self.m, 12, "M")
        p.put(self.n, 16, "N")
        p.put(self.k, 14, "K")
        p.put(int(self.relu), 1, "RELU")
        p.put(int(self.add_enable), 1, "ADD_EN")
        p.put(self.scale_shift, 5, "SCALE")
        p.put(self.rounds, 1, "ROUNDS")
        p.put(self.wchunks, 7, "WCHUNKS")

    @classmethod
    def _decode_payload(cls, op: Opcode, u: _Unpacker) -> "Compute":
        return cls(
            m=u.get(12),
            n=u.get(16),
            k=u.get(14),
            relu=bool(u.get(1)),
            add_enable=bool(u.get(1)),
            scale_shift=u.get(5),
            rounds=u.get(1),
            wchunks=u.get(7),
        )


_DECODERS: dict[Opcode, type] = {
    Opcode.PRG_PRM: ProgCtrl,
    Opcode.IM2COL_PRM: Config,
    Opcode.STRIDE_PRM: Config,
    Opcode.URAM_PRM: Config,
    Opcode.RES_ADD_STRIDE_PRM: Config,
    Opcode.LINEAR_ADM: DataMove,
    Opcode.IM2COL_ADM: DataMove,
    Opcode.STRIDE_ADM: DataMove,
    Opcode.WEIGHTS_ADM: DataMove,
    Opcode.RES_ADD_ADM: DataMove,
    Opcode.RES_ADD_STRIDE_ADM: DataMove,
    Opcode.CYCLE_ADDR: AddrCyc,
    Opcode.CYCLE_LEN: AddrLen,
    Opcode.SEND_REQ: Sync,
    Opcode.SEND_ACK: Sync,
    Opcode.WAIT_REQ: Sync,
    Opcode.WAIT_ACK: Sync,
    Opcode.GEMM: Compute,
}


def effective_opcode(inst: Instruction) -> Opcode:
    return getattr(inst, "op", inst.opcode)


def validate_group(inst: Instruction, group: Group) -> None:
    op = effective_opcode(inst)
    if op not in GROUP_OPCODES[group]:
        raise ValueError(f"opcode {op.name} not permitted in ICU group {group.value}")
