"""LF glottal-flow model: closed-form pulse spectrum + implicit-parameter solve.

Implements the four-parameter LF model (Fant, Liljencrants & Lin, STL-QPSR
1985) on a normalized period T0=1:

  opening phase  (0..te):   E1(t) = E0 e^{alpha t} sin(wg t),  wg = pi/(oq*am)
  return  phase  (te..1):   E2(t) = -Ee/(eps ta) (e^{-eps (t-te)} - e^{-eps (1-te)})

with te = oq, tp = am*oq, and the two implicit constraints
  (a) eps*ta = 1 - e^{-eps (1-te)}           (return phase reaches ~0 at t=1)
  (b) integral_0^1 E(t) dt = 0               (flow returns to baseline)

solved for the products epar := eps*ta and alpha by Brent root finding.
The spectrum is assembled from the analytic Fourier integrals of the two
phases, derived independently here (the opening phase is the integral of a
damped sinusoid, the return phase that of a shifted exponential / line
segment; both integrals are standard closed forms).

Behavioural parity target (same parameter conventions, degenerate-case
thresholds and w->0 / eps->0 limits):
reference: MBExWN_NVoc/glottis/FglotspecLF.py:15-216 and
           MBExWN_NVoc/glottis/FglotLFsynthparams.py:12-191
Used only at model-init time (wavetable construction), pure NumPy/SciPy.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import scipy.optimize as sopt


def _cis(x):
    """e^{i x} evaluated without forming a complex exponent."""
    return np.cos(x) + 1j * np.sin(x)


def _check_shape_params(oq: float, am: float, ta: float, am_open: bool = False) -> None:
    # am_open: the closed-form spectrum is singular at am=0.5 exactly
    # (sin(wg*te) = sin(pi/am * am) -> 0), so the spectrum path excludes it
    tiny = np.finfo(np.float64).eps
    if oq <= tiny or oq >= 1 - tiny:
        raise ValueError(f"LF open quotient oq={oq:g} must lie strictly inside (0, 1)")
    if (am <= 0.5 if am_open else am < 0.5) or am >= 1 - tiny:
        raise ValueError(f"LF shape coefficient am={am:g} must lie in [0.5, 1)")
    if ta < 0 or ta > (1 - oq):
        raise ValueError(f"LF return-phase duration ta={ta:g} must lie in [0, 1-oq]")


def lf_synth_params(oq: float, am: float, ta: float):
    """Solve the LF implicit equations for (alpha, epar, ta).

    Returns the synthesis parameters alpha and epar = eps*ta, possibly
    adapting ta in degenerate configurations (very large oq, or ta filling
    nearly the whole closed phase), with the same branch thresholds as the
    reference solver (FglotLFsynthparams.py:119-133).
    """
    _check_shape_params(oq, am, ta)

    te = oq
    wg = np.pi / (oq * am)
    cos_wgte = np.cos(wg * te)
    sin_wgte = np.sin(wg * te)

    def _bracketed_root(resid):
        # expand a symmetric bracket until the sign changes, then Brent-solve
        lo, hi = 0.0, 0.1
        at_zero = resid(0.0)
        if np.abs(at_zero) > np.finfo(np.float64).eps:
            while (at_zero * resid(hi) > 0) and (at_zero * resid(-hi) > 0):
                lo = hi
                hi += 1.0
            if resid(-hi) * at_zero < 0:
                lo, hi = -lo, -hi
        else:
            lo, hi = -0.1, 0.1
        return sopt.brentq(resid, lo, hi)

    if ta <= np.finfo(np.float32).eps:
        # abrupt closure: zero-area condition reduces to
        # e^{alpha te}(wg cos(wg te) - alpha sin(wg te)) = wg
        alpha = _bracketed_root(lambda a: np.exp(a * oq) * (wg * cos_wgte - a * sin_wgte) - wg)
        return alpha, 0.0, 0.0

    if oq > 0.999:
        # nearly no closed phase: the solve is ill-conditioned and the pulse
        # shape barely depends on ta -- pin intermediate values
        epar = 0.5
        ta = 0.5 * (1 - oq)
    elif ta > 0.99 * (1 - oq):
        # return phase degenerates to a straight line
        epar = 0.0
        ta = 1 - oq
    else:
        # solve epar = 1 - e^{epar (te-1)/ta}; the bracket starts at the
        # stationary point of the residual, epar_min = -ln(-(te-1)/ta)/((te-1)/ta)
        slope = (te - 1) / ta
        bracket_lo = -np.log(-slope) / slope
        epar = sopt.brentq(lambda e: e - 1 + np.exp(e * slope), bracket_lo, 1.1)

    # area under the return phase, integral_{te}^{1} E2(t) dt (shifted form)
    if epar == 0:
        ret_area = -ta / 2
    else:
        end_decay = np.exp(epar / ta * (te - 1))
        ret_area = (-end_decay * (ta + epar - te * epar) + ta) / (epar * (-1 + end_decay))

    # zero-net-area condition for alpha given the return-phase area
    wg_sq = wg**2

    def _area_resid(a):
        return -(-wg * cos_wgte + a * sin_wgte + wg * np.exp(-a * te)) / (a**2 + wg_sq) / sin_wgte + ret_area

    alpha = _bracketed_root(_area_resid)
    return alpha, epar, ta


class LFSpectrum(NamedTuple):
    """Closed-form LF spectrum split by phase, plus the resolved parameters.

    Tuple-compatible with the historical 6-tuple return
    (spec, open_phase, return_phase, alpha, epar, ta).
    """

    spec: np.ndarray
    open_phase: np.ndarray
    return_phase: np.ndarray
    alpha: float
    epar: float
    ta: float


def _open_phase_spectrum(w, alpha, wg, te, Ee, dtype):
    """Fourier integral of the opening phase E0 e^{alpha t} sin(wg t), 0..te.

    Writing sin as complex exponentials gives two geometric-type integrals;
    the scale is fixed by E(te) = -Ee.
    """
    # half of the L-model amplitude E0 = -Ee / (e^{alpha te} sin(wg te))
    half_amp = dtype(-0.5 * Ee / (np.exp(alpha * te) * np.sin(wg * te)))
    # its value propagated to t = te (computed in log space to share the exp)
    endpoint = dtype(np.exp(alpha * te + np.log(half_amp)))

    # guard the removable singularity when alpha ~ 0 and some w hits wg exactly
    tiny = np.finfo(dtype).eps
    denom_nudge = tiny if (np.abs(alpha) < tiny and np.min(np.abs(w - wg)) < tiny) else 0.0

    return (endpoint * _cis(te * (wg - w)) - half_amp) / (1j * alpha + (w - wg + denom_nudge)) - (
        endpoint * _cis(-te * (w + wg)) - half_amp
    ) / (1j * alpha + (w + wg))


def _return_phase_spectrum(w, epar, ta, te, Ee, dtype):
    """Fourier integral of the return phase over [te, te+ta] (epar>0: shifted
    exponential decay; epar==0: straight line from -Ee to 0)."""
    nz = np.flatnonzero(w > np.finfo(w.dtype).eps)
    if epar > 0:
        end_decay = np.exp(epar * (te - 1) / ta)
        phase_te = _cis(-te * w)
        # (e^{-i te w} - e^{-i w}) / w, continued at w=0 by its l'Hopital
        # limit -i(te-1) so the DC bin stays analytically exact
        diff_ratio = np.ones(w.shape, dtype=dtype) * (-1j * (te - 1))
        diff_ratio[nz] = (phase_te[nz] - _cis(-w[nz])) / w[nz]
        return ((Ee * ta * (1 - end_decay)) * phase_te + (1j * Ee * epar * end_decay) * diff_ratio) / (
            w * (1j * ta * (end_decay - 1)) + epar * (end_decay - 1)
        )
    # epar == 0: Fourier integral of (t-ta)/ta e^{-iwt} over [0, ta] (w=0
    # limit -ta/2), then delayed to start at t = te
    line_spec = Ee * ta * 0.5 * np.ones(w.shape, dtype=dtype) + ta * 0j
    line_spec[nz] = Ee * (1j * ta * w[nz] - 1 + np.exp(-1j * w[nz] * ta)) / (ta * w[nz] ** 2)
    return line_spec * np.exp(-1j * te * w)


def _flow_dc_value(alpha, epar, ta, te, wg, Ee):
    """DC bin of the integrated flow: time-domain integrals of t*E(t) terms,
    evaluated analytically for both phases."""
    amp = -Ee / (np.exp(alpha * te) * np.sin(wg * te))
    dc_open = (
        amp
        * (
            -2 * alpha * np.exp(alpha * te) * wg * np.cos(wg * te)
            + alpha**2 * np.exp(alpha * te) * np.sin(wg * te)
            - wg**2 * np.exp(alpha * te) * np.sin(wg * te)
            + wg * te * alpha**2
            + wg**3 * te
            + 2 * alpha * wg
        )
        / (alpha**2 + wg**2) ** 2
    )
    if ta > 0:
        eps_rate = epar / ta
        decay = np.exp(eps_rate * (-1 + te))
        dc_ret = (
            -0.5
            * Ee
            * ta**2
            * (
                decay
                * (2 + eps_rate**2 + 2 * eps_rate + (eps_rate * te) ** 2 - 2 * eps_rate * te - 2 * eps_rate**2 * te)
                - 2
            )
            / (epar**3)
        )
    else:
        dc_ret = 0
    return dc_open + dc_ret


def lf_pulse_spectrum(
    f,
    oq,
    am,
    ta,
    Ee=1.0,
    alpha=-1.0,
    epar=-1.0,
    orig=0.0,
    get_derivative=True,
    dtype=np.float64,
):
    """Closed-form spectrum of the LF glottal-flow derivative (or the flow).

    f is the frequency axis normalized by the fundamental (harmonic k at
    value k).  Pass alpha/epar to skip the implicit solve (alpha<=0 solves
    them from oq/am/ta).  orig shifts the pulse in time via a spectral delay.

    Returns an LFSpectrum (a NamedTuple, index-compatible with the reference
    6-tuple, FglotspecLF.py:15-216).
    """
    _check_shape_params(oq, am, ta, am_open=True)
    if ta > 0 and alpha > 0 and epar < 0:
        raise ValueError("alpha was given without epar; both are required when ta > 0")

    te = dtype(oq)
    wg = dtype(np.pi / (oq * am))
    if alpha <= 0:
        alpha, epar, ta = lf_synth_params(oq, am, ta)
    alpha = dtype(alpha)
    epar = dtype(epar)
    ta = dtype(ta)

    w = (np.asarray(f) * 2 * np.pi).astype(dtype, copy=False)

    open_spec = _open_phase_spectrum(w, alpha, wg, te, Ee, dtype)
    if ta == 0:
        ret_spec = dtype(0)
        spec = open_spec
    else:
        ret_spec = _return_phase_spectrum(w, epar, ta, te, Ee, dtype)
        spec = open_spec + ret_spec

    if get_derivative:
        if w[0] == 0:
            spec[0] = 0
    else:
        # integrate: flow = derivative / (iw); the DC value comes from the
        # analytic time-domain integrals instead
        if w[0] != 0:
            spec = spec / (1j * w)
        else:
            spec[1:] = spec[1:] / (1j * w[1:])
            spec[0] = _flow_dc_value(alpha, epar, ta, te, wg, Ee)

    if abs(orig) > 0:
        spec = spec * _cis(w * dtype(orig))

    return LFSpectrum(spec, open_spec, ret_spec, alpha, epar, ta)
