"""Device decode of the reference's interleaved tANS / rANS streams (magic
FF 02 / 04 / 84, and FF 08 through an rANS decode table).

Counterpart of ``mic_tpu.tpu.pallas_tans``:

* ``fse_parse_header``, ``_pack_dtable`` and ``build_tans_batch`` — the
  numpy header split and operand builder, carried over unchanged so their
  arrays are identical (pinned by ``tests/test_torch_tans_decode.py``);
* ``tans_decode`` and ``tans_decode_groups`` — the wrappers of the CUDA
  kernel in ``csrc/tans_decode.cu`` (replacing
  ``pallas_tans.py:_kernel_tans``): one group of same-N streams, and
  several groups (any coders and N) in one launch; each with a launch
  counter (``.launches``) and a plain-PyTorch twin
  (``tans_decode_plain``, ``tans_decode_groups_plain``);
* ``TansPacking`` (``pack_blocks``) — the host side of that launch:
  streams packed into blocks by the shared memory of their own tables,
  longest chains first, by default a stream per warp scheduler, and the
  kernel's descriptors;
* ``TansDecodePlan`` / ``fse_decompress_device_batch(blobs, device)`` —
  route, stage and decode a batch of blobs.

Each stream is N interleaved states reading one reverse bitstream: per
step, lane j of the N decodes symbol ``t*N + j`` from its state x
(``pk = tpk[x]``: ``rank << 19 | newState << 5 | nb``; the symbol is
``alpha[rank]``), then reads its ``nb`` bits, which lie below those of
lanes < j: ``x' = newState + bits(pos - cumsum(nb)[j], nb[j])``, and the
stream's cursor ``pos`` falls by the lanes' total.

Routing is ``mic_tpu``'s, decided from the headers before any launch.  A
stream decodes on the host (``ops/fse_codec.fse_decompress_auto``) when
it is 1-state (no count), has tableLog > 13, or sits in a group of
``mic_tpu``'s routing — same coder, N, tableLog and power-of-two step
bucket — in which any stream has more than 4096 distinct symbols.  The
rest decode in one launch: the streams of every (coder, N) group share
one grid.  ``TansDecodePlan.stats`` says how many streams, and which,
went to the host.

A wrapper takes the plain version only for tensors on the CPU.  For a
CUDA tensor it launches its kernel or raises.  Operands travel as int32
bit-views (``rans_decode.to_device``) and the plain version holds every
u32 quantity in int64 (torch on the CPU has no uint32 arithmetic).

Out-of-range guards, taken identically by the kernel and the plain
version: the word window of each output row (128 / N steps) starts at
the aligned block ``max(pos - 128 * tableLog - 64, 0) >> 12`` (in words:
``<< 7``), clamped to the array's last two blocks, and every read index
clamps into its 256 words, as the Pallas window does (``:103-118``,
``:142``); so reads below bit 0 (the state updates after a lane's last
symbol, or an over-claimed count) stay in the array and give the Pallas
kernel's bits, not the host reader's zeros; on honest streams no emitted
symbol depends on them.  A state beyond its table or a rank beyond the
alphabet reads 0 (the Pallas sweeps match no tile; built tables never
reach it); with per-stream ``sizes`` the same holds at the stream's own
table and alphabet lengths, and since the operands pad both with zeros
the result does not change.  Shifts by 32 do not occur: the high word is
joined only for a bit offset > 0, and ``nb`` < 32.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.bitio import ReverseBitReader
from ..ops.fse import build_dtable, read_ncount
from ..ops.fse_codec import (
    MAGIC_2STATE,
    MAGIC_4STATE,
    MAGIC_8STATE_FSE,
    MAGIC_8STATE_RANS,
    fse_decompress_auto,
)
from ..ops.rans import build_rans_dec_table
from .rans_decode import _U32, _as_i16, _check, _u, to_device

__all__ = [
    "TANS_MAX_TABLE_LOG",
    "TANS_MAX_ALPHABET",
    "fse_parse_header",
    "build_tans_batch",
    "tans_decode",
    "tans_decode_plain",
    "tans_decode_groups",
    "tans_decode_groups_plain",
    "TansPacking",
    "pack_blocks",
    "TansDecodePlan",
    "fse_decompress_device_batch",
]

TANS_MAX_TABLE_LOG = 13  # rank(12) + newStateBase(tl<=13 -> 14) + nb(5) = 31 bits
TANS_MAX_ALPHABET = 4096


def fse_parse_header(blob: bytes):
    """Split a reference entropy blob into (n_states, count, body bytes,
    coder).  count is None for the 1-state format (implicit termination,
    decoded on the host).  coder is 'tans' for FF 02/04/84 and 'rans' for
    the 8-state rANS format FF 08 (rans8state.go:14-17): the decode step
    is the same, only the table construction differs."""
    if len(blob) >= 6:
        for magic, n, coder in (
            (MAGIC_8STATE_FSE, 8, "tans"),
            (MAGIC_8STATE_RANS, 8, "rans"),
            (MAGIC_4STATE, 4, "tans"),
            (MAGIC_2STATE, 2, "tans"),
        ):
            if blob[:2] == magic:
                return n, int.from_bytes(blob[2:6], "little"), blob[6:], coder
    return 1, None, blob, "tans"


def _pack_dtable(norm, symbol_len: int, table_log: int, coder: str = "tans"):
    """Packed dtable + alphabet for the kernel; returns None if the
    stream exceeds the kernel caps (the caller decodes it on the host)."""
    if table_log > TANS_MAX_TABLE_LOG:
        return None
    if coder == "rans":
        new_state, symbol, nb_bits = build_rans_dec_table(norm, symbol_len, table_log)
    else:
        new_state, symbol, nb_bits, _zero_bits = build_dtable(norm, symbol_len, table_log)
    alpha_syms = np.unique(symbol)
    if len(alpha_syms) > TANS_MAX_ALPHABET:
        return None
    rank = np.searchsorted(alpha_syms, symbol).astype(np.uint32)
    if new_state.max() >= (1 << 14) or nb_bits.max() >= 32:
        return None
    packed = (rank << 19) | (new_state.astype(np.uint32) << 5) | nb_bits.astype(np.uint32)
    return packed, alpha_syms.astype(np.uint32)


def build_tans_batch(parsed, n_states: int, min_steps: int = 0, coder: str = "tans"):
    """Stage a batch of same-N ANS streams for the kernel.

    parsed: list of (count, norm, symbol_len, table_log, bits), the
    output of read_ncount + header split.  ``coder`` selects the decode
    table construction ('tans' = co-prime spread, 'rans' = linear fill).
    Returns (operands, steps, table_log, asweep) or None if any stream
    exceeds the kernel caps.
    """
    R = len(parsed)
    tl_max = max(p[3] for p in parsed)
    if tl_max > TANS_MAX_TABLE_LOG:
        return None
    TS = max(128, 1 << tl_max)
    SPR = 128 // n_states
    steps = max(min_steps, max(-(-p[0] // n_states) for p in parsed))
    steps = -(-steps // (8 * SPR)) * (8 * SPR)  # 8 output rows per store

    tpk = np.zeros((R, TS), np.uint32)
    alphas = []
    init = np.zeros((R, 128), np.uint32)
    pos = np.zeros((R, 128), np.int32)
    cnt = np.zeros((R, 128), np.uint32)
    wmax = 0
    words_list = []
    for i, (count, norm, symbol_len, tl, bits) in enumerate(parsed):
        pk = _pack_dtable(norm, symbol_len, tl, coder)
        if pk is None:
            return None
        packed, alpha_syms = pk
        tpk[i, : len(packed)] = packed
        alphas.append(alpha_syms)
        r = ReverseBitReader(bits)
        for j in range(n_states):
            init[i, j] = r.get_bits(tl)
        pos[i, :] = r.pos
        cnt[i, :] = count
        w = np.frombuffer(bits + b"\x00" * ((-len(bits)) % 4), dtype="<u4")
        words_list.append(w)
        wmax = max(wmax, len(w))
    WB = -(-(wmax) // 128) + 2  # +2 pad blocks: the window is two blocks
    words = np.zeros((R, WB * 128), np.uint32)
    for i, w in enumerate(words_list):
        words[i, : len(w)] = w
    words = words.reshape(R, WB, 128)

    amax = max(len(a) for a in alphas)
    asweep = 1
    while asweep * 128 < amax:
        asweep *= 2
    alpha = np.zeros((R, asweep * 128), np.uint32)
    for i, a in enumerate(alphas):
        alpha[i, : len(a)] = a
    return (init, pos, cnt, tpk, alpha, words), steps, tl_max, asweep


# ---------------------------------------------------------------------------
# The kernel's wrappers and their plain twins
# ---------------------------------------------------------------------------


def _tans_operands(init, pos, cnt, tpk, alpha, words, steps, n_states, table_log):
    """Checks the operands; returns (R, table width, alphabet width, word
    blocks)."""
    if n_states not in (2, 4, 8):
        raise ValueError(f"n_states must be 2, 4 or 8, got {n_states}")
    if not 1 <= table_log <= TANS_MAX_TABLE_LOG:
        raise ValueError(f"table_log must be in [1, {TANS_MAX_TABLE_LOG}], got {table_log}")
    spr = 128 // n_states
    if steps <= 0 or steps % (8 * spr):
        raise ValueError(f"steps must be a positive multiple of {8 * spr}, got {steps}")
    if not isinstance(init, torch.Tensor) or init.dim() != 2:
        raise ValueError("init: expected an int32 [R, 128] tensor")
    R, dev = init.shape[0], init.device
    ts = max(128, 1 << table_log)
    asz = alpha.shape[-1] if alpha.dim() == 2 else -1
    if asz <= 0 or asz % 128 or asz > TANS_MAX_ALPHABET:
        raise ValueError(f"alpha width {asz}: expected a multiple of 128 up to "
                         f"{TANS_MAX_ALPHABET}")
    wb = words.shape[1] if words.dim() == 3 else 0
    if wb < 2:
        raise ValueError("words: expected [R, blocks >= 2, 128]")
    for name, t, shape in (("init", init, (R, 128)), ("pos", pos, (R, 128)),
                           ("cnt", cnt, (R, 128)), ("tpk", tpk, (R, ts)),
                           ("alpha", alpha, (R, asz)), ("words", words, (R, wb, 128))):
        _check(name, t, shape, dev)
    return R, ts, asz, wb


def _check_sizes(sizes, R: int, ts: int, asz: int, dev) -> np.ndarray:
    """Checks a per-stream ``sizes`` operand (int32 [R, 2]: each stream's
    own table and alphabet words, multiples of 128 from 128 up to the
    operands' widths); returns it as a host array."""
    _check("sizes", sizes, (R, 2), dev)
    host = sizes.cpu().numpy()
    if ((host < 128) | (host % 128 != 0) | (host > np.array([ts, asz]))).any():
        raise ValueError(f"sizes: expected multiples of 128 in [128, {ts}] (table) and "
                         f"[128, {asz}] (alphabet)")
    return host


def tans_decode_plain(init, pos, cnt, tpk, alpha, words, *, steps: int, n_states: int,
                      table_log: int, sizes=None) -> torch.Tensor:
    """Plain-PyTorch twin of the tANS kernel (any device).  Same operands
    and output as :func:`tans_decode`."""
    R, ts, asz, wb = _tans_operands(init, pos, cnt, tpk, alpha, words, steps, n_states,
                                    table_log)
    N, spr, dev = n_states, 128 // n_states, init.device
    own_ts, own_asz = ts, asz
    if sizes is not None:
        _check_sizes(sizes, R, ts, asz, dev)
        own_ts, own_asz = sizes[:, :1].to(torch.int64), sizes[:, 1:].to(torch.int64)
    x = _u(init[:, :N])
    p = pos[:, :1].to(torch.int64)
    c = cnt[:, :1].to(torch.int64)  # the int32 view: the Pallas kernel compares as int32
    tpk, alpha = _u(tpk), _u(alpha)
    w = _u(words).reshape(R, -1)
    lane = torch.arange(N, device=dev)
    out = torch.zeros((R, steps, N), dtype=torch.int16, device=dev)
    # Rows past every stream's count have no active lane: they stay 0.
    rows = min(steps // spr, -(-max(int(c.max()) if R else 0, 0) // (spr * N)))
    for row in range(rows):
        base = (((p - 128 * table_log - 64).clamp(min=0) >> 12) << 7).clamp(max=(wb - 2) * 128)
        for t in range(row * spr, (row + 1) * spr):
            pk = torch.where(x < own_ts, torch.gather(tpk, 1, x.clamp(max=ts - 1)), 0)
            rank = pk >> 19
            sym = torch.where(rank < own_asz,
                              torch.gather(alpha, 1, rank.clamp(max=asz - 1)), 0)
            active = (t * N + lane) < c
            nb = torch.where(active, pk & 31, 0)
            cum = torch.cumsum(nb, dim=1)
            start = p - cum
            idx = base + (start >> 5).sub(base).clamp(0, 254)
            off = start & 31
            lo = torch.gather(w, 1, idx) >> off
            hi = torch.where(off > 0, (torch.gather(w, 1, idx + 1) << (32 - off)) & _U32, 0)
            val = (lo | hi) & ((1 << nb) - 1)
            x = torch.where(active, ((pk >> 5) & 0x3FFF) + val, x)
            p = p - cum[:, -1:]
            out[:, t] = _as_i16(torch.where(active, sym, 0))
    return out.reshape(R, steps * N // 128, 128)


def tans_decode_groups_plain(groups) -> list[torch.Tensor]:
    """Plain-PyTorch twin of :func:`tans_decode_groups` (any device): each
    group through :func:`tans_decode_plain` with its ``sizes``."""
    return [tans_decode_plain(*ops, sizes=sizes, **kw) for ops, sizes, kw in groups]


# Shared memory of the merged launch.  A stream takes its own table and
# alphabet plus a fixed part (csrc/tans_decode.cu: kFixedWords): a ring of
# four 128-word blocks of its bitstream with 8 words of wrap-around pad,
# and one output row.
STREAM_FIXED_BYTES = 4 * (512 + 8 + 64)
MAX_WARPS = 8             # streams (one warp each) a block holds at most
MAX_GROUPS = 8            # groups one launch takes (the kernel's Outs)
MAX_POOL_BYTES = 232448   # dynamic shared memory one block may take on sm_90
# The launch's default shape: 4 streams a block and a pool of the whole SM,
# so one block per SM and a stream per warp scheduler.  A stream's step is
# a short chain of dependent instructions that every lane of its warp
# issues, and more streams on an SM slow the longest chains, which a batch
# lasts, by more than they add (NVIDIA H100, scripts/tans_design_points.py,
# PERF.md: 1.202 ms against 1.478 ms with the most streams an SM holds).
DEFAULT_WARPS = 4
# Nanoseconds of one step by N on that card (the same script): they weigh
# chains of different N against each other when blocks are ordered.
STEP_NS = {2: 35, 4: 60, 8: 120}
_GROUP_DESC = np.dtype([("ptr", "<u8", (7,)), ("i", "<i4", (6,))])  # the kernel's GroupDesc


def stream_bytes(sizes: np.ndarray) -> np.ndarray:
    """Shared-memory bytes of each stream of a host ``sizes`` array."""
    return 4 * sizes.astype(np.int64).sum(axis=1) + STREAM_FIXED_BYTES


def pack_blocks(needs, chains, pool_bytes: int, warps: int):
    """Pack the streams of some groups into blocks of at most ``warps``
    streams and ``pool_bytes`` of shared memory.

    ``needs[g]`` and ``chains[g]`` are group g's per-stream shared-memory
    bytes (multiples of 16) and chain lengths (the time until the stream's
    count is decoded, in any one unit).  Within a group the streams are
    taken longest chain first and a block is filled with consecutive ones,
    so that they end together and the block frees its SM; a block holds
    one group.  Blocks are ordered longest chain first over all groups.
    Returns a list of (group, stream indices, byte offsets into the
    block's pool).
    """
    blocks = []
    for g, (need, chain) in enumerate(zip(needs, chains)):
        if len(need) and int(max(need)) > pool_bytes:
            raise ValueError(f"a stream needs {int(max(need))} bytes of shared memory, "
                             f"the pool has {pool_bytes}")
        streams, offs, used = [], [], 0
        for s in np.argsort(-np.asarray(chain, np.int64), kind="stable").tolist():
            if streams and (len(streams) == warps or used + int(need[s]) > pool_bytes):
                blocks.append((g, streams, offs))
                streams, offs, used = [], [], 0
            streams.append(s)
            offs.append(used)
            used += int(need[s])
        if streams:
            blocks.append((g, streams, offs))
    blocks.sort(key=lambda b: -int(chains[b[0]][b[1][0]]))  # stable: ties keep group order
    return blocks


class TansPacking:
    """The streams of some groups packed into the blocks of one launch,
    with the kernel's descriptors on the device.

    ``groups`` is a list of ``(operands, sizes, kwargs)``: the six operand
    tensors of :func:`tans_decode`, the per-stream int32 [R, 2] ``sizes``
    (None: the operands' widths) and ``steps`` / ``n_states`` /
    ``table_log``.  Every tensor is checked, ``sizes`` and the counts are
    read back once, and the packing (:func:`pack_blocks` with ``warps``
    streams a block and ``pool_bytes`` of shared memory, chains weighed by
    ``STEP_NS``) and the descriptors are built.  The packing holds the
    groups' tensors: it is valid for them only.
    """

    def __init__(self, groups, *, warps: int = DEFAULT_WARPS, pool_bytes: int = MAX_POOL_BYTES):
        if not 1 <= warps <= MAX_WARPS:
            raise ValueError(f"warps must be in [1, {MAX_WARPS}], got {warps}")
        if not 0 < pool_bytes <= MAX_POOL_BYTES or pool_bytes % 16:
            raise ValueError(f"pool_bytes must be a multiple of 16 up to {MAX_POOL_BYTES}, "
                             f"got {pool_bytes}")
        if not 1 <= len(groups) <= MAX_GROUPS:
            raise ValueError(f"expected 1 to {MAX_GROUPS} groups, got {len(groups)}")
        self.groups = []
        self.out_shapes, needs, chains = [], [], []
        desc = np.zeros(len(groups), _GROUP_DESC)
        dev = groups[0][0][0].device if isinstance(groups[0][0][0], torch.Tensor) else None
        for g, (ops, sizes, kw) in enumerate(groups):
            R, ts, asz, wb = _tans_operands(*ops, **kw)
            if ops[0].device != dev:
                raise ValueError(f"group {g} on {ops[0].device}, group 0 on {dev}")
            if sizes is None:
                sizes = torch.tensor([[ts, asz]], dtype=torch.int32, device=dev).repeat(R, 1)
            host = _check_sizes(sizes, R, ts, asz, dev)
            tensors = (*ops, sizes)
            if any(t.data_ptr() % 16 for t in tensors):
                raise ValueError(f"group {g}: operands must be 16-byte aligned")
            n = kw["n_states"]
            count = ops[2][:, 0].cpu().numpy().astype(np.int64)  # the int32 view, as compared
            needs.append(stream_bytes(host))
            chains.append(-(-np.clip(count, 0, kw["steps"] * n) // n) * STEP_NS[n])
            desc[g] = ([t.data_ptr() for t in tensors],
                       [ts, asz, wb, kw["steps"], kw["table_log"], n])
            self.groups.append((tuple(ops), sizes, dict(kw)))
            self.out_shapes.append((R, kw["steps"] * n // 128, 128))
        self.blocks = pack_blocks(needs, chains, pool_bytes, warps)
        self.warps, self.pool_bytes = warps, pool_bytes
        wdesc = np.full((len(self.blocks), warps, 4), -1, np.int32)
        for b, (g, streams, offs) in enumerate(self.blocks):
            k = len(streams)
            wdesc[b, :k, 0], wdesc[b, :k, 1] = g, streams
            wdesc[b, :k, 2] = np.asarray(offs) // 4
        self.device = dev
        if dev is not None and dev.type == "cuda":
            self.gdesc = torch.from_numpy(desc.view(np.uint8).reshape(-1)).to(dev)
            self.wdesc = torch.from_numpy(wdesc.reshape(-1)).to(dev)

    def holds(self, groups) -> bool:
        """Whether ``groups`` are the tensors this packing was built for."""
        return len(groups) == len(self.groups) and all(
            all(a is b for a, b in zip(ops, mine[0])) and (sizes is None or sizes is mine[1])
            and dict(kw) == mine[2] for (ops, sizes, kw), mine in zip(groups, self.groups))


def _launch(packing: TansPacking, lib=None) -> list[torch.Tensor]:
    """The merged kernel over a packing's groups: one launch, or none when
    no group has a stream."""
    dev = packing.device
    if dev is None or dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    outs = [torch.empty(shape, dtype=torch.int16, device=dev) for shape in packing.out_shapes]
    if not packing.blocks:
        return outs
    import ctypes

    if lib is None:
        from .._build import kernel_library

        lib = kernel_library()
    ptrs = (ctypes.c_void_p * len(outs))(*(o.data_ptr() for o in outs))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mic_tans_decode_groups(packing.gdesc.data_ptr(), packing.wdesc.data_ptr(), ptrs,
                                        len(outs), len(packing.blocks), packing.warps,
                                        packing.pool_bytes, stream)
    if rc != 0:
        raise RuntimeError(f"mic_tans_decode_groups launch failed: CUDA error {rc}")
    return outs


def tans_decode(init, pos, cnt, tpk, alpha, words, *, steps: int, n_states: int,
                table_log: int, sizes=None) -> torch.Tensor:
    """Decode R interleaved-tANS streams of N states each.

    Operands are int32 bit-views (``rans_decode.to_device``) of
    :func:`build_tans_batch`'s six arrays: init [R, 128] (the N initial
    states in lanes 0..N-1), pos [R, 128] (the bit cursor after the init
    reads), cnt [R, 128] (symbol counts), tpk [R, max(128, 2^table_log)],
    alpha [R, asweep * 128], words [R, WB, 128].  ``table_log`` is the
    largest of the streams' tableLogs (<= 13).  ``sizes``, when given, is
    int32 [R, 2]: the words of each stream's own table and alphabet
    (multiples of 128 up to the operands' widths), beyond which its rows
    of ``tpk`` and ``alpha`` are not read (they count as 0, which is what
    the operands' padding holds).  Returns int16 [R, steps * N / 128,
    128]: flattened, row s is stream s's u16 symbols in order (bit-view),
    0 wherever ``t * N + lane >= count``.  CPU tensors take the plain
    version; CUDA tensors launch the kernel of ``csrc/tans_decode.cu``.
    """
    ops = (init, pos, cnt, tpk, alpha, words)
    kw = dict(steps=steps, n_states=n_states, table_log=table_log)
    _tans_operands(*ops, **kw)
    if init.device.type == "cpu":
        return tans_decode_plain(*ops, sizes=sizes, **kw)
    if init.device.type != "cuda":
        raise ValueError(f"unsupported device {init.device}")
    packing = TansPacking([(ops, sizes, kw)])
    (out,) = _launch(packing)
    if packing.blocks:
        tans_decode.launches += 1
    return out


tans_decode.launches = 0


def tans_decode_groups(groups, packing: TansPacking | None = None) -> list[torch.Tensor]:
    """Decode the streams of several groups in one launch.

    ``groups`` is a list of ``(operands, sizes, kwargs)`` as
    :class:`TansPacking` takes them (coders and state counts may differ
    between groups); returns one output per group, each as
    :func:`tans_decode` returns it.  ``packing`` is a packing built
    earlier for these very tensors (a plan builds it once); without it
    one is built here, which reads the counts back.  CPU tensors take the
    plain version group by group; CUDA tensors launch the kernel of
    ``csrc/tans_decode.cu`` once.
    """
    if not groups:
        return []
    dev = groups[0][0][0].device
    if dev.type == "cpu":
        return tans_decode_groups_plain(groups)
    if packing is None:
        packing = TansPacking(groups)
    elif not packing.holds(groups):
        raise ValueError("packing was built for other groups")
    outs = _launch(packing)
    if packing.blocks:
        tans_decode_groups.launches += 1
    return outs


tans_decode_groups.launches = 0


# ---------------------------------------------------------------------------
# Batch decode: routing, staging, launches
# ---------------------------------------------------------------------------


def _step_bucket(count: int, n: int) -> int:
    """``mic_tpu``'s power-of-two step bucket (part of its routing key)."""
    b = 8 * (128 // n)
    need = -(-count // n)
    while b < need:
        b *= 2
    return b


def _stack_padded(arrays) -> np.ndarray:
    """Concatenate operand arrays along the stream axis, zero-padding the
    other axes to the largest: what ``build_tans_batch`` builds for the
    streams of all of them at once."""
    shape = tuple(max(a.shape[d] for a in arrays) for d in range(1, arrays[0].ndim))
    out = np.zeros((sum(len(a) for a in arrays), *shape), arrays[0].dtype)
    r = 0
    for a in arrays:
        out[(slice(r, r + len(a)), *(slice(0, n) for n in a.shape[1:]))] = a
        r += len(a)
    return out


def _own_sizes(table_logs, alpha: np.ndarray) -> np.ndarray:
    """The ``sizes`` operand of staged streams: each stream's own table
    words (``max(128, 2^tableLog)``) and alphabet words (its symbols,
    rounded up to 128) from its tableLog and its row of ``alpha`` (sorted
    distinct symbols, zero-padded: only the first can be 0)."""
    filled = alpha != 0
    n_alpha = np.where(filled.any(axis=1),
                       alpha.shape[1] - np.argmax(filled[:, ::-1], axis=1), 1)
    own_ts = np.maximum(128, 1 << np.asarray(table_logs, np.int64))
    return np.stack([own_ts, -(-n_alpha // 128) * 128], axis=1).astype(np.int32)


class TansDecodePlan:
    """A batch of reference entropy blobs, routed and staged on ``device``.

    ``__init__`` parses every header, routes each stream (kernel or host,
    as the module docstring says), builds each routing group's operands
    once (``build_tans_batch``, as ``mic_tpu`` does), merges the groups of
    one coder and N into one group of operands, longest streams first,
    copies them to the device with each stream's own table and alphabet
    sizes, and packs the streams of all groups into the blocks of one
    launch (:class:`TansPacking`); ``run()`` launches the kernel once and
    returns one output per group; ``results(outs)`` decodes the
    host-routed streams and returns every stream's symbols (numpy uint16)
    in blob order.

    ``stats``: ``streams`` (blobs), ``kernel`` (streams routed to the
    kernel), ``host`` (the blob indices routed to the host, in order),
    ``symbols`` (the kernel streams' symbol count), ``groups`` (groups of
    one coder and N), ``launches`` (kernel launches per ``run()``: 1, or 0
    with no kernel stream), ``table_logs`` (kernel streams per tableLog).
    """

    def __init__(self, blobs, device):
        self.blobs = list(blobs)
        self.device = torch.device(device)
        host, routed = [], {}
        for bi, blob in enumerate(self.blobs):
            n, count, body, coder = fse_parse_header(blob)
            if n == 1 or count is None:
                host.append(bi)
                continue
            norm, symbol_len, tl, consumed = read_ncount(body)
            if tl > TANS_MAX_TABLE_LOG:
                host.append(bi)
                continue
            entry = (count, norm, symbol_len, tl, body[consumed:])
            routed.setdefault((coder, n, tl, _step_bucket(count, n)), []).append((bi, entry))
        launch = {}
        for (coder, n, _tl, _b), items in routed.items():
            built = build_tans_batch([e for _bi, e in items], n, min_steps=8 * (128 // n),
                                     coder=coder)
            if built is None:
                host += [bi for bi, _e in items]
            else:
                launch.setdefault((coder, n), []).append((items, built))
        self.host = sorted(host)
        self.groups = []  # (blob indices, counts, device operands, kwargs)
        self.sizes = []   # per group: int32 [R, 2] on the device
        table_logs = {}
        for (coder, n), parts in launch.items():
            items = [it for its, _b in parts for it in its]
            ops = [_stack_padded([b[0][k] for _its, b in parts]) for k in range(6)]
            order = np.argsort([-e[0] for _bi, e in items], kind="stable")
            ops = [a[order] for a in ops]
            items = [items[i] for i in order]
            kw = dict(steps=max(b[1] for _its, b in parts), n_states=n,
                      table_log=max(b[2] for _its, b in parts))
            self.groups.append(([bi for bi, _e in items], [e[0] for _bi, e in items],
                                to_device(ops, self.device), kw))
            sizes = _own_sizes([e[3] for _bi, e in items], ops[4])
            self.sizes.append(torch.from_numpy(sizes).to(self.device))
            for _bi, e in items:
                table_logs[e[3]] = table_logs.get(e[3], 0) + 1
        self._launch_groups = [(ops, sizes, kw)
                               for (_i, _c, ops, kw), sizes in zip(self.groups, self.sizes)]
        self.packing = (TansPacking(self._launch_groups)
                        if self.groups and self.device.type == "cuda" else None)
        n_kernel = sum(len(g[0]) for g in self.groups)
        self.stats = {"streams": len(self.blobs), "kernel": n_kernel, "host": list(self.host),
                      "symbols": sum(sum(g[1]) for g in self.groups),
                      "groups": len(self.groups), "launches": 1 if self.groups else 0,
                      "table_logs": dict(sorted(table_logs.items()))}

    def run(self) -> list[torch.Tensor]:
        """One kernel launch for all groups; the outputs, one per group,
        stay on the device."""
        return tans_decode_groups(self._launch_groups, self.packing)

    def results(self, outs) -> list[np.ndarray]:
        """Every stream's symbols in blob order: the kernel outputs, and the
        host decode of the host-routed streams."""
        results = [None] * len(self.blobs)
        for (idx, counts, _ops, _kw), out in zip(self.groups, outs):
            flat = out.reshape(out.shape[0], -1).cpu().numpy().view(np.uint16)
            for j, (bi, count) in enumerate(zip(idx, counts)):
                results[bi] = flat[j, :count].copy()
        for bi in self.host:
            results[bi] = fse_decompress_auto(self.blobs[bi])
        return results


def fse_decompress_device_batch(blobs, device, stats: dict | None = None) -> list[np.ndarray]:
    """Decode a batch of reference entropy blobs (FF 02/04/84/08, and
    1-state) with the entropy stage on ``device``.  Returns numpy uint16
    symbol arrays in blob order, bit-exact against
    ``ops.fse_codec.fse_decompress_auto``.  ``stats``, when a dict,
    receives :class:`TansDecodePlan`'s ``stats``."""
    plan = TansDecodePlan(blobs, device)
    if stats is not None:
        stats.update(plan.stats)
    return plan.results(plan.run())
