"""Calibrated physical / technology constants for the EasyACIM estimation model.

The paper (DAC'24, TSMC28) publishes the *form* of the estimation model
(Eqs. 2-11) but not the fitted constants (cell areas, ADC energy coefficients
k1/k2, timing constants, C0, kappa, k3/k4).  We therefore calibrate them
against the paper's own reported numbers, exactly as a user of the flow would
calibrate against post-layout simulation (the paper itself obtains k1/k2
"from post-layout simulation").

Anchors used (all from the paper text):
  [T1] Fig. 8(a): 16 kb, H=128, W=128, L=2, B_ADC=3  ->  3.277 TOPS.
       With t_cycle = t_com + 0.69*tau*B + t_conv_bit*B this pins
       t_cycle(B=3) = 2*(H/L)*W / 3.2768e12 = 5.000 ns exactly:
           t_com = 0.40 ns, 0.69*tau*3 = 1.00 ns (tau = 0.4831 ns),
           t_conv_bit = 1.20 ns  (3.6 ns for 3 bits).
       Cross-check Fig. 8(b): H=512, W=32, L=8, B=3 -> 2*2048/5ns =
       0.8192 TOPS vs paper "0.813" (+0.8%), and Fig. 8(c) H=256, W=64,
       L=8 gives the *same* throughput at +3 dB SNR, matching the text.
  [A1] Fig. 8(a) area 4504 F^2/bit at (H=128, L=2, B=3),
  [A2] design-space floor  ~1500 F^2/bit (paper Fig. 9/10), anchored at
       (L=32, H=2048, B=1),
  [A3] design-space ceiling ~7500 F^2/bit, anchored at (L=2, H=64, B=5).
       Solving Eq. 10 through [A1][A2][A3] exactly (with A_DFF chosen at
       4759 F^2, a dynamic DFF + per-bit RBL switch) gives
           A_SRAM = 1304.7 F^2 (~1.0 um^2 8T compute cell @28nm - sane)
           A_LC   =  704.0 F^2 (local cap + switch cell)
           A_COMP = 350175 F^2 (~275 um^2: comparator + column SAR
                                periphery lumped, per paper's A_COMP term)
       Prediction check: Fig. 8(b) -> 2125 (paper 2610, -19%: its exact
       (H,L) is not published), Fig. 8(c) -> 2837 (paper 2977, -4.7%).
  [E1] energy-efficiency span 50-750 TOPS/W (paper Fig. 10):
       EE = 2000 / E_fJ per 1b-MAC.  Low end pinned at (B=8, H/L=256):
       E_ADC(8) ~ 9.6 pJ -> E = 2.5 + 37.5 fJ -> 50 TOPS/W.  High end at
       (B=1, H/L=2048): E = 2.5 + 0.115 fJ -> ~765 TOPS/W.
           E_compute + E_control = 2.5 fJ, k1 = 276 fJ, k2 = 0.14 fJ.
  [S1] SNR model constants: C0 = 2 fF compute cap, kappa = 0.45 %*sqrt(fF)
       (Tripathi & Murmann metal-fringe mismatch [28]), kT @ 300 K.
       Eq. 11's (k3, k4) are *derived* from the full model (Eqs. 2-6) by
       least squares in `fit_eq11_constants` and verified by a unit test.

Everything downstream reads from the frozen `CAL28` instance; an alternative
technology can be modelled by constructing another `CalibConstants`.

A copy of `repro.core.constants`: the port imports nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import math

BOLTZMANN = 1.380649e-23  # J/K


@dataclasses.dataclass(frozen=True)
class CalibConstants:
    """Technology calibration for the estimation model (defaults: TSMC28)."""

    # --- timing (Eq. 7) ------------------------------------------------
    t_com: float = 0.40e-9        # MAC (charge-share) phase [s]
    tau: float = 0.4831e-9        # RBL settling time constant [s]
    t_conv_bit: float = 1.20e-9   # SAR conversion time per bit [s]

    # --- energy (Eqs. 8-9), femtojoules per 1b MAC ---------------------
    e_compute_fj: float = 1.5
    e_control_fj: float = 1.0
    k1_fj: float = 276.0          # Murmann ADC model, linear term
    k2_fj: float = 0.14           # Murmann ADC model, 4^B term
    v_dd: float = 0.9             # [V]

    # --- area (Eq. 10), F^2 ---------------------------------------------
    a_sram: float = 1304.7        # 8T compute bit-cell
    a_lc: float = 704.0           # local-array shared cap + control cell
    a_comp: float = 350175.0      # column comparator + SAR periphery
    a_dff: float = 4759.0         # per-ADC-bit DFF + RBL switch

    # --- SNR (Eqs. 2-6) -------------------------------------------------
    c0_ff: float = 2.0            # compute capacitor [fF]
    kappa: float = 0.0045         # mismatch coeff, sigma(dC/C)=kappa/sqrt(C_fF)
    temperature_k: float = 300.0
    b_w: int = 1                  # weight bits (paper: 1b x 1b computation)
    b_x: int = 1                  # activation bits
    # normalized signal statistics.  1-bit (Rademacher) signals:
    # E[x^2] = x_m^2 = 1, sigma_w = w_m = 1, zeta = x_m/sigma = 1 (0 dB).
    x_m: float = 1.0
    w_m: float = 1.0
    sigma_x: float = 1.0
    sigma_w: float = 1.0
    e_x2: float = 1.0             # E[x^2]
    sigma_inj2: float = 0.0       # charge-injection noise: killed by
    #                               bottom-plate sampling (paper Sec. 3.2.1)

    # --- search-space bounds (paper Sec. 4) ------------------------------
    l_min: int = 2
    l_max: int = 32
    b_min: int = 1
    b_max: int = 8
    h_min: int = 64     # paper Fig. 9(c)(d) explores H >= 64
    h_max: int = 4096
    w_min: int = 8

    @property
    def kt(self) -> float:
        return BOLTZMANN * self.temperature_k

    @property
    def e_cc_fj(self) -> float:
        """E_compute + E_control (Eq. 8, design-point independent)."""
        return self.e_compute_fj + self.e_control_fj

    @property
    def zeta_x_db(self) -> float:
        return 20.0 * math.log10(self.x_m / self.sigma_x)

    @property
    def zeta_w_db(self) -> float:
        return 20.0 * math.log10(self.w_m / self.sigma_w)


CAL28 = CalibConstants()
