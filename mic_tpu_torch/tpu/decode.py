"""Single-stream decode of a MICT blob on a device.

Counterpart of ``mic_tpu.tpu.decode``: :func:`make_plan` parses a blob
into a :class:`DecodePlan` (the slot tables, the words with one zero
after them, the initial states), and :func:`mict_decode_device` decodes
it through the lanes kernel of ``csrc/rans_lanes.cu`` with one strip
(``scan_decode.rans_decode_lanes``; its plain twin on the CPU), then
substitutes an FF 41 stream's escapes on the host with
``alias_substitute_escapes``, as ``mic_tpu`` does, which also raises on a
stream whose escape count is wrong.
"""

from __future__ import annotations

import numpy as np

from .device_rans import alias_substitute_escapes, mict_parse, slot_tables
from .scan_decode import lane_tensors, rans_decode_lanes

__all__ = ["DecodePlan", "make_plan", "mict_decode_device"]


class DecodePlan:
    """The host side of one MICT blob's decode: tables, stream arrays and
    shape metadata (the fields of ``mic_tpu.tpu.decode.DecodePlan``)."""

    def __init__(self, lanes, table_log, count, init_states, words, tab_sym, tab_freq,
                 tab_bias):
        self.lanes = lanes
        self.table_log = table_log
        self.count = count
        self.init_states = init_states
        self.words = words
        self.tab_sym = tab_sym
        self.tab_freq = tab_freq
        self.tab_bias = tab_bias
        self.alias = None  # (esc_val, esc_values) for FF 41 streams

    @property
    def n_steps(self) -> int:
        return (self.count + self.lanes - 1) // self.lanes


def make_plan(blob: bytes) -> DecodePlan:
    """Parse ``blob`` into a :class:`DecodePlan`: u32 states and words
    (the words with one zero after them, so an exhausted cursor's read is
    in bounds), u16 slot symbols and u32 slot frequencies and biases."""
    L, tl, count, states, words, norm, _sl, alias = mict_parse(blob)
    sym, freq_slot, bias_slot, _, _ = slot_tables(norm, tl, alias)
    words_p = np.concatenate([words, np.zeros(1, dtype=np.uint16)])
    plan = DecodePlan(L, tl, count, states.astype(np.uint32), words_p.astype(np.uint32),
                      sym.astype(np.uint16), freq_slot.astype(np.uint32),
                      bias_slot.astype(np.uint32))
    plan.alias = alias
    return plan


def mict_decode_device(blob: bytes, device) -> np.ndarray:
    """Parse and decode one MICT blob on ``device``: u16 [count] symbols,
    escapes substituted (the counterpart of
    ``mic_tpu.tpu.decode.mict_decode_device``)."""
    p = make_plan(blob)
    arrays = (p.init_states[None], p.words.astype(np.uint16)[None], p.tab_sym, p.tab_freq,
              p.tab_bias, np.zeros(1, np.int32), np.array([p.table_log], np.int32),
              np.array([p.count], np.int32), np.full(1, -1, np.int32),
              np.zeros((1, 1), np.uint16))
    out = rans_decode_lanes(*lane_tensors(arrays, device), steps=max(1, p.n_steps))
    out = out.cpu().numpy().view(np.uint16)[0, : p.count]
    if p.alias is not None:
        out = alias_substitute_escapes(out, p.alias)
    return out
