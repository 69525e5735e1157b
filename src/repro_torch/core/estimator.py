"""ACIM performance-estimation model (paper Eqs. 2-11) on torch tensors.

Counterpart of `repro.core.estimator`.  Every public function accepts
(h, w, l, b_adc) as Python scalars or equal-shaped tensors and computes
in float32, in the reference's order of operations, so the objectives
agree with the reference to a few ulps (`log10`/`pow` differ by ulps
between libraries; the tests hold them to `rtol=1e-6`).

Model summary
-------------
SNR   (Eqs. 2-6): harmonic combination of input-quantization SQNR_i,
       analog noise SNR_a (cap mismatch + kT/C thermal + charge injection),
       and ADC quantization SQNR_y.  Dot-product length N = H/L.
SNR   (Eq. 11, simplified): 6*B - 10log10(H/L) - 10log10(k3/C0) + k4.
T     (Eq. 7): (H/L)*W / (t_com + t_set + t_conv), reported as OPS.
E     (Eqs. 8-9): E_cc + E_ADC/(H/L) per 1b-MAC (Murmann ADC model).
A     (Eq. 10): A_SRAM + A_LC/L + A_COMP/H + B*A_DFF/H   [F^2/bit].
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.constants import CAL28, CalibConstants

F32 = torch.float32
# float32(1/ln 10): the reference computes log10(x) as log(x) * this.
_INV_LN10 = float(np.float32(0.434294492))


def _f32(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(F32)
    return torch.as_tensor(np.asarray(x, np.float32))


def _div(a, b) -> torch.Tensor:
    """True float32 division with a Python scalar on either side.

    torch computes `scalar / tensor` as `reciprocal(tensor) * scalar`,
    and CUDA computes `tensor / cpu_scalar` as a multiply by the
    reciprocal; both can round differently from the reference's
    division.  A 0-d tensor on the other operand's device keeps it a
    division."""
    like = a if isinstance(a, torch.Tensor) else b
    if not isinstance(a, torch.Tensor):
        a = torch.tensor(a, dtype=F32, device=like.device)
    if not isinstance(b, torch.Tensor):
        b = torch.tensor(b, dtype=F32, device=like.device)
    return torch.div(a, b)


def _log10(x: torch.Tensor) -> torch.Tensor:
    """log10 as the reference lowers it: float32 log times 1/ln 10."""
    return torch.log(x) * _INV_LN10


def _pow(base: float, y: torch.Tensor) -> torch.Tensor:
    """base**y rounded to float32 from a float64 power (the reference's
    float32 power is correctly rounded on almost every input; torch's
    float32 `pow` is not)."""
    return torch.pow(base, y.double()).to(F32)


def _exp10(y: torch.Tensor) -> torch.Tensor:
    return _pow(10.0, y)


# ----------------------------------------------------------------------
# SNR: full model, Eqs. 2-6
# ----------------------------------------------------------------------
def sqnr_input(n, cal: CalibConstants = CAL28) -> torch.Tensor:
    """SQNR_i (Eqs. 3-4), linear; +inf for 1-bit signals."""
    n = _f32(n)
    if cal.b_w == 1 and cal.b_x == 1:
        return torch.full_like(n, float("inf"))
    delta_w = cal.w_m * 2.0 ** (-cal.b_w + 1)
    delta_x = cal.x_m * 2.0 ** (-cal.b_x)
    var_qi = _div(n, 12.0) * (delta_x**2 * cal.sigma_w**2 + delta_w**2 * cal.e_x2)
    var_y0 = n * cal.sigma_w**2 * cal.e_x2
    return _div(var_y0, var_qi)


def snr_analog(n, cal: CalibConstants = CAL28) -> torch.Tensor:
    """SNR_a (Eq. 5), linear; design-point independent for fixed C0."""
    n = _f32(n)
    c0_f = cal.c0_ff * 1e-15
    mism_rel = (cal.kappa / np.sqrt(cal.c0_ff)) ** 2
    therm_rel = 2.0 * (cal.kt / c0_f) / cal.v_dd**2
    pref = (2.0 / 3.0) * (1.0 - 4.0 ** (-cal.b_w))
    var_eta_per_n = pref * (cal.e_x2 * mism_rel + therm_rel + cal.sigma_inj2)
    var_y0_per_n = cal.sigma_w**2 * cal.e_x2
    return torch.full_like(n, float(var_y0_per_n / var_eta_per_n))


def sqnr_adc_db(n, b_adc, cal: CalibConstants = CAL28) -> torch.Tensor:
    """SQNR_y in dB (Eq. 6)."""
    n = _f32(n)
    b = _f32(b_adc)
    return (6.0 * b + 4.8 - (cal.zeta_x_db + cal.zeta_w_db)
            - 10.0 * _log10(n))


def snr_total_db(h, l, b_adc, cal: CalibConstants = CAL28) -> torch.Tensor:
    """SNR_T (Eq. 2): harmonic combination of SNR_pre and SQNR_y, in dB."""
    h = _f32(h)
    l = _f32(l)
    n = h / l
    inv_pre = _div(1.0, snr_analog(n, cal)) + _div(1.0, sqnr_input(n, cal))
    sqnr_y = _exp10(_div(sqnr_adc_db(n, b_adc, cal), 10.0))
    snr_t = _div(1.0, inv_pre + _div(1.0, sqnr_y))
    return 10.0 * _log10(snr_t)


# ----------------------------------------------------------------------
# SNR: simplified Eq. 11
# ----------------------------------------------------------------------
@functools.lru_cache(maxsize=8)
def fit_eq11_constants(cal: CalibConstants = CAL28) -> tuple[float, float]:
    """Fit (k3, k4) of Eq. 11 against the full model over the feasible
    grid (least squares for the additive constant; k3 from Eq. 5)."""
    pref = (2.0 / 3.0) * (1.0 - 4.0 ** (-cal.b_w))
    k3 = pref * (cal.e_x2 * cal.kappa**2 + 2.0 * cal.kt * 1e15 / cal.v_dd**2) / (
        cal.sigma_w**2 * cal.e_x2)
    pts = [(2**he, 2**le, b)
           for he in range(4, 13) for le in range(1, 6) for b in range(1, 9)
           if le <= he and (he - le) >= b]
    hh = np.array([p[0] for p in pts], np.float32)
    ll = np.array([p[1] for p in pts], np.float32)
    bb = np.array([p[2] for p in pts], np.float32)
    full = snr_total_db(hh, ll, bb, cal).numpy()
    base = 6.0 * bb - 10.0 * np.log10(hh / ll)
    c = float(np.mean(full - base))
    k4 = c + 10.0 * float(np.log10(k3 / cal.c0_ff))
    return float(k3), float(k4)


def snr_simplified_db(h, l, b_adc, cal: CalibConstants = CAL28) -> torch.Tensor:
    """Eq. 11 with fitted (k3, k4)."""
    k3, k4 = fit_eq11_constants(cal)
    h = _f32(h)
    l = _f32(l)
    b = _f32(b_adc)
    return (6.0 * b - 10.0 * _log10(h / l)
            - 10.0 * np.log10(k3 / cal.c0_ff) + k4)


# ----------------------------------------------------------------------
# Throughput (Eq. 7), energy (Eqs. 8-9), area (Eq. 10)
# ----------------------------------------------------------------------
def cycle_time_s(b_adc, cal: CalibConstants = CAL28) -> torch.Tensor:
    b = _f32(b_adc)
    t_set = 0.69 * cal.tau * b
    t_conv = cal.t_conv_bit * b
    return cal.t_com + t_set + t_conv


def throughput_ops(h, w, l, b_adc, cal: CalibConstants = CAL28) -> torch.Tensor:
    """Eq. 7 in OPS (1 MAC = 2 ops)."""
    h = _f32(h)
    w = _f32(w)
    l = _f32(l)
    macs_per_cycle = (h / l) * w
    return _div(2.0 * macs_per_cycle, cycle_time_s(b_adc, cal))


def adc_energy_fj(b_adc, cal: CalibConstants = CAL28) -> torch.Tensor:
    """Eq. 9 (Murmann): E_ADC = k1*(B + log2 Vdd) + k2*4^B*Vdd^2, in fJ."""
    b = _f32(b_adc)
    log2_vdd = _div(torch.log(_f32(cal.v_dd)), torch.log(_f32(2.0)))
    return cal.k1_fj * (b + log2_vdd) + cal.k2_fj * _pow(4.0, b) * cal.v_dd**2


def energy_per_mac_fj(h, l, b_adc, cal: CalibConstants = CAL28) -> torch.Tensor:
    """Eq. 8: per-1b-MAC energy; the ADC is amortized over H/L MACs."""
    h = _f32(h)
    l = _f32(l)
    return cal.e_cc_fj + _div(adc_energy_fj(b_adc, cal), _div(h, l))


def energy_efficiency_tops_w(h, l, b_adc,
                             cal: CalibConstants = CAL28) -> torch.Tensor:
    """TOPS/W = 2000 / E_fJ."""
    return _div(2000.0, energy_per_mac_fj(h, l, b_adc, cal))


def area_f2_per_bit(h, l, b_adc, cal: CalibConstants = CAL28) -> torch.Tensor:
    h = _f32(h)
    l = _f32(l)
    b = _f32(b_adc)
    return (cal.a_sram + _div(cal.a_lc, l) + _div(cal.a_comp, h)
            + _div(b * cal.a_dff, h))


# ----------------------------------------------------------------------
# Objective stack (Eq. 12): minimize [-f_SNR, -f_T, f_E, f_A]
# ----------------------------------------------------------------------
def objectives(h, w, l, b_adc, cal: CalibConstants = CAL28) -> torch.Tensor:
    """Stack the four objectives, minimization orientation, shape (..., 4),
    on the design points' device; delegates to `objectives_from_operands`
    so the Eqs. 2-11 physics exists in one place."""
    dev = h.device if isinstance(h, torch.Tensor) else "cpu"
    return objectives_from_operands(h, w, l, b_adc, cal_operands(cal, dev))


OBJECTIVE_NAMES = ("neg_snr_db", "neg_tops", "energy_fj_per_mac", "area_f2_per_bit")


class CalOperands(NamedTuple):
    """Calibration constants as float32 tensors (scalars, or one entry per
    cell of a batch), with the design-point independent combinations
    folded on the host."""

    inv_pre: torch.Tensor        # 1/SNR_a + 1/SQNR_i (linear, Eqs. 3-5)
    adc_off_db: torch.Tensor     # 4.8 - zeta_x_dB - zeta_w_dB  (Eq. 6)
    t_com: torch.Tensor          # [s]
    t_set_per_b: torch.Tensor    # 0.69 * tau [s/bit]
    t_conv_bit: torch.Tensor     # [s/bit]
    e_cc_fj: torch.Tensor        # E_compute + E_control [fJ]
    k1_fj: torch.Tensor
    k2_fj: torch.Tensor
    log2_vdd: torch.Tensor
    vdd2: torch.Tensor
    a_sram: torch.Tensor
    a_lc: torch.Tensor
    a_comp: torch.Tensor
    a_dff: torch.Tensor

    def to(self, device) -> "CalOperands":
        return CalOperands(*(x.to(device) for x in self))


def cal_operands(cal: CalibConstants = CAL28, device="cpu") -> CalOperands:
    """Fold a static `CalibConstants` into scalar float32 operands."""
    n_probe = torch.tensor(1.0, dtype=F32)
    inv_pre = (_div(1.0, snr_analog(n_probe, cal))
               + _div(1.0, sqnr_input(n_probe, cal)))
    f32 = lambda v: torch.tensor(np.float32(v))  # noqa: E731
    return CalOperands(
        inv_pre=inv_pre.reshape(()),
        adc_off_db=f32(4.8 - cal.zeta_x_db - cal.zeta_w_db),
        t_com=f32(cal.t_com),
        t_set_per_b=f32(0.69 * cal.tau),
        t_conv_bit=f32(cal.t_conv_bit),
        e_cc_fj=f32(cal.e_cc_fj),
        k1_fj=f32(cal.k1_fj),
        k2_fj=f32(cal.k2_fj),
        log2_vdd=f32(np.log2(cal.v_dd)),
        vdd2=f32(cal.v_dd**2),
        a_sram=f32(cal.a_sram),
        a_lc=f32(cal.a_lc),
        a_comp=f32(cal.a_comp),
        a_dff=f32(cal.a_dff),
    ).to(device)


def objectives_from_operands(h, w, l, b_adc, ops: CalOperands) -> torch.Tensor:
    """Eq. 12 objective stack, shape (..., 4); the operand leaves
    broadcast against the design points."""
    h = _f32(h)
    w = _f32(w)
    l = _f32(l)
    b = _f32(b_adc)
    n = h / l
    sqnr_y_db = 6.0 * b + ops.adc_off_db - 10.0 * _log10(n)
    sqnr_y = _exp10(_div(sqnr_y_db, 10.0))
    snr_db = 10.0 * _log10(_div(1.0, ops.inv_pre + _div(1.0, sqnr_y)))
    t_cycle = ops.t_com + ops.t_set_per_b * b + ops.t_conv_bit * b
    tops = _div(2.0 * n * w / t_cycle, 1e12)
    e_adc = ops.k1_fj * (b + ops.log2_vdd) + ops.k2_fj * _pow(4.0, b) * ops.vdd2
    e = ops.e_cc_fj + e_adc / n
    a = ops.a_sram + ops.a_lc / l + ops.a_comp / h + b * ops.a_dff / h
    return torch.stack([-snr_db, -tops, e, a], dim=-1)


def evaluate_report(h, w, l, b_adc, cal: CalibConstants = CAL28) -> dict:
    """Human-oriented metrics for one or more design points (tensors)."""
    return {
        "snr_db": snr_total_db(h, l, b_adc, cal),
        "snr_eq11_db": snr_simplified_db(h, l, b_adc, cal),
        "tops": _div(throughput_ops(h, w, l, b_adc, cal), 1e12),
        "energy_fj_per_mac": energy_per_mac_fj(h, l, b_adc, cal),
        "tops_per_w": energy_efficiency_tops_w(h, l, b_adc, cal),
        "area_f2_per_bit": area_f2_per_bit(h, l, b_adc, cal),
        "cycle_ns": cycle_time_s(b_adc, cal) * 1e9,
    }
