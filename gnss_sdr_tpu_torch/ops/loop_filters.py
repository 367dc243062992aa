"""Digital tracking loop filters as pure carry-state update functions.

Equivalent role to the reference's ``tracking_2nd_DLL_filter.cc`` /
``tracking_2nd_PLL_filter.cc`` / ``tracking_FLL_PLL_filter.cc``: classic
Kaplan-style 2nd/3rd-order controllers, written as stateless (state-in,
state-out) float32 functions on ``[C]`` tensors.

Loop natural frequencies from noise bandwidth (Kaplan & Hegarty tables):
  2nd order: w0 = Bn / 0.53,   a2 = 1.414
  3rd order: w0 = Bn / 0.7845, a3 = 1.1, b3 = 2.4
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gnss_sdr_tpu_torch.ops.correlator import const


def _mul(c, t):
    """c * t; a Python number c is made a tensor once (:func:`const`)."""
    if isinstance(c, torch.Tensor) or not isinstance(t, torch.Tensor):
        return c * t
    return const(c, t) * t


class Loop3State(NamedTuple):
    """Third-order loop integrators (also used for FLL-assisted PLL)."""

    acc1: torch.Tensor  # first integrator  (output accumulator)
    acc2: torch.Tensor  # second integrator


def pll3_update(state: Loop3State, phase_err_cycles: torch.Tensor,
                freq_err_hz: torch.Tensor, dt_s: torch.Tensor,
                pll_bw_hz, fll_bw_hz) -> tuple[Loop3State, torch.Tensor]:
    """FLL-assisted 3rd-order PLL update; returns (state, freq_out_hz).

    With fll_bw == 0 this is a pure 3rd-order PLL. Errors: phase in cycles,
    frequency in Hz; output frequency command in Hz.
    """
    w0p = pll_bw_hz / 0.7845
    a3 = 1.1
    b3 = 2.4
    w0f = fll_bw_hz / 0.53
    a2 = 1.414

    acc2 = state.acc2 + dt_s * (w0p ** 3 * phase_err_cycles
                                + _mul(w0f ** 2, freq_err_hz))
    acc1 = state.acc1 + dt_s * (acc2
                                + _mul(a3, w0p ** 2) * phase_err_cycles
                                + _mul(_mul(a2, w0f), freq_err_hz))
    out = acc1 + _mul(b3, w0p) * phase_err_cycles
    return Loop3State(acc1=acc1, acc2=acc2), out


class Loop2State(NamedTuple):
    acc1: torch.Tensor


def dll2_update(state: Loop2State, code_err_chips: torch.Tensor,
                dt_s: torch.Tensor, dll_bw_hz) -> tuple[Loop2State, torch.Tensor]:
    """2nd-order DLL; error in chips, output in chips/s."""
    w0 = dll_bw_hz / 0.53
    a2 = 1.414
    acc1 = state.acc1 + dt_s * w0 ** 2 * code_err_chips
    out = acc1 + _mul(a2, w0) * code_err_chips
    return Loop2State(acc1=acc1), out
