"""The timed runner's compare on the device: the mismatching pixels of a
``MicwDecodePlan`` run against the expected pixels, and its probe.

Counterpart of the compare and the probe inside ``mic_tpu``'s
``MicwDecodePlan.make_timed_runner`` (``mic_tpu/tpu/strips.py:2294-2306``:
``sum((out[:, :cols] != exp) & (lane < valid))`` a bucket, ``valid`` an
int32 a row, and ``out[0, :8]`` summed), which XLA fuses into the
runner's one program.

* :func:`expected_rows` — a bucket's expected pixels as the runner and
  ``verify_batch`` stage them: rows padded to the bucket's widest
  segment, and each row's valid length (0 for a row with none);
* :func:`bucket_mismatches_plain` / :func:`probe_plain` — the plain
  PyTorch twins of the kernel's two sums;
* :class:`MismatchPacking` — what one runner compares, laid out once:
  per bucket its rows, its distinct expected rows and a row map (row
  ``r`` of the output against expected row ``rowmap[r]``: a batch that
  replicates a blob stages its rows once), the compare blocks, and on the
  card the descriptors in one copy;
* :func:`count_mismatches` — one run's outputs through
  ``csrc/verify.cu:mismatch_groups_kernel`` on the card, one launch for
  up to ``MAX_GROUPS`` buckets (``.launches`` counts them), or through
  :func:`count_mismatches_plain` on the CPU.

A CUDA tensor launches the kernel or raises; only CPU tensors take the
plain twin.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["CHUNK", "MAX_GROUPS", "PROBE", "MismatchPacking", "bucket_mismatches_plain",
           "count_mismatches", "count_mismatches_plain", "expected_rows", "probe_plain"]

MAX_GROUPS = 128  # buckets a launch (csrc/verify.cu: kMaxGroups)
CHUNK = 32768  # pixels a compare block reads of each side at most (64 KB)
PROBE = 8  # the probe's pixels a bucket: out[0, :8]
_GROUP_DESC = np.dtype([("exp", "<u8"), ("valid", "<u8"), ("rowmap", "<u8"), ("cols", "<i4"),
                        ("pad", "<i4")])


def expected_rows(rows: dict, n_rows: int):
    """A bucket's first ``n_rows`` expected rows from ``rows`` ({row: u16
    pixels}): (u16 [n_rows, cols], every row padded with zeros to the
    widest segment; int32 [n_rows], each row's valid length, 0 where
    ``rows`` has none)."""
    cols = max(len(s) for s in rows.values())
    exp = np.zeros((n_rows, cols), np.uint16)
    valid = np.zeros(n_rows, np.int32)
    for i, s in rows.items():
        if i < n_rows:
            exp[i, : len(s)] = s
            valid[i] = len(s)
    return exp, valid


def bucket_mismatches_plain(out: torch.Tensor, exp: torch.Tensor, valid: torch.Tensor,
                            rowmap: torch.Tensor | None = None):
    """Mismatching pixels of a bucket's output (int16 [S, >= cols])
    against its expected rows (int16 [U, cols]) and their valid lengths
    (int32 [U]): row ``r`` against expected row ``rowmap[r]`` (int32 [S];
    None: ``r``, U = S) over its first ``valid[rowmap[r]]`` columns.  A
    0-d int64 tensor on the output's device."""
    cols = exp.shape[1]
    if rowmap is not None:
        exp, valid = exp[rowmap.long()], valid[rowmap.long()]
    if exp.shape[0] != out.shape[0]:
        raise ValueError(f"{exp.shape[0]} expected rows for {out.shape[0]} output rows")
    lane = torch.arange(cols, device=out.device)
    return ((out[:, :cols] != exp) & (lane < valid[:, None])).sum()


def probe_plain(outs) -> torch.Tensor:
    """The sum of each output's ``out[0, :8]`` as u16 values (0-d int64)."""
    return sum(((o[0, :PROBE].to(torch.int64) & 0xFFFF).sum() for o in outs),
               torch.zeros((), dtype=torch.int64))


class MismatchPacking:
    """What one runner compares, laid out for ``mismatch_groups_kernel``.

    ``rows`` is each bucket's strip count in the plan's order; ``staged``
    per bucket None (not compared: its rows have no expected pixels) or
    ``(exp, valid, rowmap)``: :func:`expected_rows`' pair for the
    bucket's distinct expected rows and the int32 [rows] map of each
    output row to one of them.  ``expected`` holds those triples as
    tensors on ``device``; ``blocks`` (int32 [n, 4]: group, row, c0, c1)
    the compare's chunks of at most ``CHUNK`` pixels, each below its
    row's valid length, bucket after bucket (rows of valid length 0 have
    none); ``parts`` the (first group, end group, first block, end block)
    of each launch, ``MAX_GROUPS`` buckets a launch, group numbers in
    ``blocks`` counted from the part's first.  The expected rows go to
    ``device`` once, here; on a CUDA device the group descriptors and the
    blocks follow in one copy from pinned memory, queued on the current
    stream."""

    def __init__(self, rows, staged, device):
        self.device = torch.device(device)
        self.rows = [int(r) for r in rows]
        if len(staged) != len(self.rows):
            raise ValueError(f"{len(staged)} staged buckets for {len(self.rows)} row counts")
        self.expected, blocks, self.parts = [], [], []
        n_blocks = 0
        for g0 in range(0, len(self.rows), MAX_GROUPS):
            g1, b0 = min(g0 + MAX_GROUPS, len(self.rows)), n_blocks
            for g in range(g0, g1):
                if staged[g] is None:
                    self.expected.append(None)
                    continue
                exp, valid, rowmap = staged[g]
                if (exp.shape[0] != valid.size or rowmap.shape != (self.rows[g],)
                        or not ((rowmap >= 0) & (rowmap < valid.size)).all()):
                    raise ValueError(f"bucket {g}: a row map of {rowmap.shape} over "
                                     f"{valid.size} expected rows for {self.rows[g]} rows")
                self.expected.append(tuple(torch.from_numpy(a).to(self.device) for a in
                                           (exp.view(np.int16), valid, rowmap.astype(np.int32))))
                blocks.append(_chunks(g - g0, valid[rowmap]))
                n_blocks += len(blocks[-1])
            self.parts.append((g0, g1, b0, n_blocks))
        self.blocks = np.concatenate(blocks) if blocks else np.zeros((0, 4), np.int32)
        # the last output layout count_mismatches checked, its row strides
        # and widths
        self.checked = self.strides = self.widths = None
        if self.device.type == "cuda":
            self._upload()

    def _upload(self) -> None:
        """Group descriptors and blocks to the card: one device buffer,
        filled by one non-blocking copy from pinned memory."""
        n = len(self.rows)
        gbytes, bbytes = n * _GROUP_DESC.itemsize, self.blocks.nbytes
        buf = torch.empty(gbytes + bbytes + 16, dtype=torch.uint8, device=self.device)
        desc = np.zeros(n, _GROUP_DESC)
        for g, staged in enumerate(self.expected):
            if staged is not None:
                exp, valid, rowmap = staged
                desc[g] = (exp.data_ptr(), valid.data_ptr(), rowmap.data_ptr(), exp.shape[1], 0)
        host = torch.empty(buf.numel(), dtype=torch.uint8, pin_memory=True)
        raw = host.numpy()
        raw[:gbytes] = desc.view(np.uint8)
        b_at = -(-gbytes // 16) * 16  # int4 blocks on a 16-byte boundary
        raw[b_at:b_at + bbytes] = self.blocks.view(np.uint8).reshape(-1)
        buf.copy_(host, non_blocking=True)
        self._buf = buf
        self.gdesc_ptr = buf.data_ptr()
        self.bdesc_ptr = buf.data_ptr() + b_at


def _chunks(g: int, lengths: np.ndarray) -> np.ndarray:
    """Compare blocks of group ``g``: (g, row, c0, c1) for every chunk of
    ``CHUNK`` pixels below each row's valid length (``lengths``, a row)."""
    v = lengths.astype(np.int64)
    n = -(-v // CHUNK)
    row = np.repeat(np.arange(v.size), n)
    c0 = (np.arange(row.size) - np.repeat(np.cumsum(n) - n, n)) * CHUNK
    c1 = np.minimum(c0 + CHUNK, v[row])
    return np.stack([np.full(row.size, g), row, c0, c1], axis=1).astype(np.int32)


def _on(t: torch.Tensor, device: torch.device) -> bool:
    """Whether ``t`` lies on ``device`` (a device with no index names the
    current one of its type)."""
    return t.device.type == device.type and (
        device.index is None or t.device.index in (None, device.index))


def count_mismatches_plain(packing: MismatchPacking, outs, acc: torch.Tensor,
                           compare: bool = True) -> None:
    """Plain-PyTorch twin of :func:`count_mismatches`, on any device."""
    if compare:
        for out, staged in zip(outs, packing.expected):
            if staged is not None:
                acc[0] += bucket_mismatches_plain(out, *staged).to(acc.device)
    acc[1] += probe_plain(outs).to(acc.device)


def _check(packing: MismatchPacking, outs, acc: torch.Tensor) -> None:
    """Raises unless ``outs`` and ``acc`` are what :func:`count_mismatches`
    takes for ``packing``."""
    if len(outs) != len(packing.rows):
        raise ValueError(f"{len(outs)} outputs for a packing of {len(packing.rows)} buckets")
    if acc.dtype != torch.int64 or acc.shape != (2,) or not _on(acc, packing.device):
        raise ValueError(f"acc must be int64 [2] on {packing.device}, got {acc.dtype} "
                         f"{tuple(acc.shape)} on {acc.device}")
    for g, (out, S, staged) in enumerate(zip(outs, packing.rows, packing.expected)):
        cols = 0 if staged is None else staged[0].shape[1]
        if (out.dtype != torch.int16 or out.dim() != 2 or out.shape[0] != S
                or out.shape[1] < max(cols, 1) or not _on(out, packing.device)):
            raise ValueError(f"output {g}: expected int16 [{S}, >= {max(cols, 1)}] on "
                             f"{packing.device}, got {out.dtype} {tuple(out.shape)} on "
                             f"{out.device}")
        if out.stride(1) != 1:
            raise ValueError(f"output {g}: columns must be contiguous (stride {out.stride()})")


def count_mismatches(packing: MismatchPacking, outs, acc: torch.Tensor,
                     compare: bool = True) -> None:
    """Adds one run's mismatching pixels against ``packing``'s expected
    rows to ``acc[0]`` (where ``compare``) and each output's ``out[0, :8]``
    as u16 values to ``acc[1]``; ``acc`` is an int64 [2] tensor on the
    packing's device, ``outs`` the plan's bucket outputs in the packing's
    order (int16 [S, width], columns contiguous, rows at any stride).  No
    host sync.  CPU tensors take :func:`count_mismatches_plain`; CUDA
    tensors launch ``mismatch_groups_kernel`` of ``csrc/verify.cu``, once
    per ``MAX_GROUPS`` buckets (with ``compare`` False, the probe alone)."""
    outs = list(outs)
    # a plan's runs repeat one layout: the checks run where it changes
    layout = [(t.dtype, t.shape, t.stride(), t.device) for t in (*outs, acc)]
    if layout != packing.checked:
        _check(packing, outs, acc)
        packing.checked = layout
        packing.strides = np.array([o.stride(0) for o in outs], np.int64)
        packing.widths = np.array([o.shape[1] for o in outs], np.int32)
    if not outs:
        return
    if packing.device.type == "cpu":
        count_mismatches_plain(packing, outs, acc, compare)
        return
    if packing.device.type != "cuda":
        raise ValueError(f"unsupported device {packing.device}")
    from .._build import kernel_library

    lib = kernel_library()
    ptrs = np.array([o.data_ptr() for o in outs], np.uint64)
    with torch.cuda.device(packing.device):
        stream = torch.cuda.current_stream().cuda_stream
        for g0, g1, b0, b1 in packing.parts:
            rc = lib.mic_mismatch_groups(
                packing.gdesc_ptr + g0 * _GROUP_DESC.itemsize, packing.bdesc_ptr + b0 * 16,
                b1 - b0 if compare else 0, ptrs.ctypes.data + 8 * g0,
                packing.strides.ctypes.data + 8 * g0, packing.widths.ctypes.data + 4 * g0,
                g1 - g0, acc.data_ptr(), stream)
            if rc != 0:
                raise RuntimeError(f"mic_mismatch_groups launch failed: CUDA error {rc}")
            count_mismatches.launches += 1


count_mismatches.launches = 0
