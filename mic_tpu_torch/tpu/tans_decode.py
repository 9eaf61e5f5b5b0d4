"""Device decode of the reference's interleaved tANS / rANS streams (magic
FF 02 / 04 / 84, and FF 08 through an rANS decode table).

Counterpart of ``mic_tpu.tpu.pallas_tans``:

* ``fse_parse_header``, ``_pack_dtable`` and ``build_tans_batch`` — the
  numpy header split and operand builder, carried over unchanged so their
  arrays are identical (pinned by ``tests/test_torch_tans_decode.py``);
* ``tans_decode`` — the wrapper of the CUDA kernel in
  ``csrc/tans_decode.cu`` (replacing ``pallas_tans.py:_kernel_tans``),
  with a launch counter (``.launches``), and ``tans_decode_plain``, its
  plain-PyTorch twin;
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
rest decode in one launch per (coder, N).  ``TansDecodePlan.stats`` says
how many streams, and which, went to the host.

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
reach it).  Shifts by 32 do not occur: the high word is joined only for
a bit offset > 0, and ``nb`` < 32.
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
# The kernel's wrapper and its plain twin
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


def tans_decode_plain(init, pos, cnt, tpk, alpha, words, *, steps: int, n_states: int,
                      table_log: int) -> torch.Tensor:
    """Plain-PyTorch twin of the tANS kernel (any device).  Same operands
    and output as :func:`tans_decode`."""
    R, ts, asz, wb = _tans_operands(init, pos, cnt, tpk, alpha, words, steps, n_states,
                                    table_log)
    N, spr, dev = n_states, 128 // n_states, init.device
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
            pk = torch.where(x < ts, torch.gather(tpk, 1, x.clamp(max=ts - 1)), 0)
            rank = pk >> 19
            sym = torch.where(rank < asz, torch.gather(alpha, 1, rank.clamp(max=asz - 1)), 0)
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


def tans_decode(init, pos, cnt, tpk, alpha, words, *, steps: int, n_states: int,
                table_log: int) -> torch.Tensor:
    """Decode R interleaved-tANS streams of N states each.

    Operands are int32 bit-views (``rans_decode.to_device``) of
    :func:`build_tans_batch`'s six arrays: init [R, 128] (the N initial
    states in lanes 0..N-1), pos [R, 128] (the bit cursor after the init
    reads), cnt [R, 128] (symbol counts), tpk [R, max(128, 2^table_log)],
    alpha [R, asweep * 128], words [R, WB, 128].  ``table_log`` is the
    largest of the streams' tableLogs (<= 13).  Returns int16 [R, steps *
    N / 128, 128]: flattened, row s is stream s's u16 symbols in order
    (bit-view), 0 wherever ``t * N + lane >= count``.  CPU tensors take
    the plain version; CUDA tensors launch the kernel of
    ``csrc/tans_decode.cu``.
    """
    R, ts, asz, wb = _tans_operands(init, pos, cnt, tpk, alpha, words, steps, n_states,
                                    table_log)
    if init.device.type == "cpu":
        return tans_decode_plain(init, pos, cnt, tpk, alpha, words, steps=steps,
                                 n_states=n_states, table_log=table_log)
    if init.device.type != "cuda":
        raise ValueError(f"unsupported device {init.device}")
    out = torch.empty((R, steps * n_states // 128, 128), dtype=torch.int16, device=init.device)
    if R == 0:
        return out
    from .._build import kernel_library

    lib = kernel_library()
    with torch.cuda.device(init.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mic_tans_decode(init.data_ptr(), pos.data_ptr(), cnt.data_ptr(),
                                 tpk.data_ptr(), ts, alpha.data_ptr(), asz, words.data_ptr(),
                                 wb, out.data_ptr(), R, steps, n_states, table_log, stream)
    if rc != 0:
        raise RuntimeError(f"mic_tans_decode launch failed: CUDA error {rc}")
    tans_decode.launches += 1
    return out


tans_decode.launches = 0


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


class TansDecodePlan:
    """A batch of reference entropy blobs, routed and staged on ``device``.

    ``__init__`` parses every header, routes each stream (kernel or host,
    as the module docstring says), builds each routing group's operands
    once (``build_tans_batch``, as ``mic_tpu`` does), merges the groups of
    one coder and N into one launch, longest streams first (a block that
    ends early frees its SM for the next), and copies them to the device;
    ``run()`` launches the kernel once per launch group and returns the
    outputs; ``results(outs)`` decodes the host-routed streams and returns
    every stream's symbols (numpy uint16) in blob order.

    ``stats``: ``streams`` (blobs), ``kernel`` (streams routed to the
    kernel), ``host`` (the blob indices routed to the host, in order),
    ``symbols`` (the kernel streams' symbol count), ``groups`` (launches
    per ``run()``).
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
        n_kernel = sum(len(g[0]) for g in self.groups)
        self.stats = {"streams": len(self.blobs), "kernel": n_kernel, "host": list(self.host),
                      "symbols": sum(sum(g[1]) for g in self.groups),
                      "groups": len(self.groups)}

    def run(self) -> list[torch.Tensor]:
        """One kernel launch per group; the outputs stay on the device."""
        return [tans_decode(*ops, **kw) for _idx, _cnt, ops, kw in self.groups]

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
