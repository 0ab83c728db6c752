"""IMEX Butcher tableaus + set-up-time unrolling of the recursive residuals.

The port's own copy of incompressibleeulerhdg_tpu/timesteppers/tableaus.py
(numpy only, equal tables; tests/test_torch_shared.py holds them equal).
The tableaus are those of the reference solver's hdg_imex.py.

Note on ARS3(4,4,3): the reference's ``_b_impl`` returns the length-6 vector
[0, 3/2, -3, 2, 1/2, 1/2] for a 5-stage scheme (hdg_imex.py:874); its final
residual only reads the first five entries, so the *effective* weights
[0, 3/2, -3, 2, 1/2] differ from the standard ARS3(4,4,3) tableau
[0, 3/2, -3/2, 1/2, 1/2] — almost certainly a typo ("-3, 2" for "-3/2").
This rebuild implements the standard (correct) tableau.

The reference evaluates stage residuals recursively at assembly time
(hdg_imex.py:367-413); here the recursion is unrolled once at setup into
dense coefficient matrices:

    r_i(w)     = sum_j alpha[i, j] (Q_j, w)  + dt sum_j beta[i, j] (b_j, w)
    r_final(w) = sum_j alpha_f[j]  (Q_j, w)  + dt sum_j beta_f[j]  (b_j, w)
"""

from dataclasses import dataclass
import numpy as np

__all__ = ["IMEXTableau", "TABLEAUS", "unroll_residual_coefficients"]


@dataclass(frozen=True)
class IMEXTableau:
    name: str
    label: str
    a_expl: np.ndarray
    a_impl: np.ndarray
    b_expl: np.ndarray
    b_impl: np.ndarray
    c_expl: np.ndarray

    @property
    def nstages(self):
        return self.a_expl.shape[0]


def _implicit_euler():
    """2-stage backward-Euler-as-IMEX (hdg_imex.py:668-729)."""
    return IMEXTableau(
        name="imex_implicit",
        label="HDG IMEX Implicit",
        a_expl=np.array([[0.0, 0.0], [1.0, 0.0]]),
        a_impl=np.array([[0.0, 0.0], [0.0, 1.0]]),
        b_expl=np.array([1.0, 0.0]),
        b_impl=np.array([0.0, 1.0]),
        c_expl=np.array([0.0, 1.0]),
    )


def _ars2_232():
    """ARS2(2,3,2), gamma = 1 - 1/sqrt(2) (hdg_imex.py:732-799)."""
    gamma = 1.0 - 1.0 / np.sqrt(2.0)
    delta = -2.0 / 3.0 * np.sqrt(2.0)
    return IMEXTableau(
        name="imex_ars2_232",
        label="HDG IMEX ARS2(2,3,2)",
        a_expl=np.array([[0, 0, 0], [gamma, 0, 0], [delta, 1 - delta, 0]]),
        a_impl=np.array([[0, 0, 0], [0, gamma, 0], [0, 1 - gamma, gamma]]),
        b_expl=np.array([0.0, 1 - gamma, gamma]),
        b_impl=np.array([0.0, 1 - gamma, gamma]),
        c_expl=np.array([0.0, gamma, 1.0]),
    )


def _ars3_443():
    """ARS3(4,4,3), 5 stages (hdg_imex.py:802-879); b_impl typo corrected."""
    return IMEXTableau(
        name="imex_ars3_443",
        label="HDG IMEX ARS3(4,4,3)",
        a_expl=np.array(
            [
                [0, 0, 0, 0, 0],
                [1 / 2, 0, 0, 0, 0],
                [11 / 18, 1 / 18, 0, 0, 0],
                [5 / 6, -5 / 6, 1 / 2, 0, 0],
                [1 / 4, 7 / 4, 3 / 4, -7 / 4, 0],
            ]
        ),
        a_impl=np.array(
            [
                [0, 0, 0, 0, 0],
                [0, 1 / 2, 0, 0, 0],
                [0, 1 / 6, 1 / 2, 0, 0],
                [0, -1 / 2, 1 / 2, 1 / 2, 0],
                [0, 3 / 2, -3 / 2, 1 / 2, 1 / 2],
            ]
        ),
        b_expl=np.array([1 / 4, 7 / 4, 3 / 4, -7 / 4, 0]),
        b_impl=np.array([0, 3 / 2, -3 / 2, 1 / 2, 1 / 2]),
        c_expl=np.array([0, 1 / 2, 2 / 3, 1 / 2, 1]),
    )


def _ssp2_332():
    """SSP2(3,3,2) (hdg_imex.py:882-949) — the driver default."""
    return IMEXTableau(
        name="imex_ssp2_332",
        label="HDG IMEX SSP2(3,3,2)",
        a_expl=np.array([[0, 0, 0], [1 / 2, 0, 0], [1 / 2, 1 / 2, 0]]),
        a_impl=np.array([[1 / 4, 0, 0], [0, 1 / 4, 0], [1 / 3, 1 / 3, 1 / 3]]),
        b_expl=np.array([1 / 3, 1 / 3, 1 / 3]),
        b_impl=np.array([1 / 3, 1 / 3, 1 / 3]),
        c_expl=np.array([0.0, 1.0, 1 / 2]),
    )


def _ssp3_433():
    """SSP3(4,3,3), Pareschi-Russo constants (hdg_imex.py:952-1038)."""
    alpha = 0.24169426078821
    beta = 0.06042356519705
    eta = 0.12915286960590
    delta = 1 / 2 - alpha - beta - eta
    return IMEXTableau(
        name="imex_ssp3_433",
        label="HDG IMEX SSP3(4,3,3)",
        a_expl=np.array(
            [[0, 0, 0, 0], [0, 0, 0, 0], [0, 1, 0, 0], [0, 1 / 4, 1 / 4, 0]]
        ),
        a_impl=np.array(
            [
                [alpha, 0, 0, 0],
                [-alpha, alpha, 0, 0],
                [0, 1 - alpha, alpha, 0],
                [beta, eta, delta, alpha],
            ]
        ),
        b_expl=np.array([0, 1 / 6, 1 / 6, 2 / 3]),
        b_impl=np.array([0, 1 / 6, 1 / 6, 2 / 3]),
        c_expl=np.array([0.0, 0.0, 1.0, 1 / 2]),
    )


TABLEAUS = {
    t.name: t
    for t in (_implicit_euler(), _ars2_232(), _ars3_443(), _ssp2_332(), _ssp3_433())
}


def unroll_residual_coefficients(tab):
    """Unroll the recursive stage residuals (hdg_imex.py:367-413).

    Returns (alpha (s, s), beta (s, s), alpha_f (s,), beta_f (s,)) with

        r_i     = sum_j alpha[i,j] M Q_j + dt sum_j beta[i,j] M b_j
        r_final = sum_j alpha_f[j] M Q_j + dt sum_j beta_f[j] M b_j
    """
    s = tab.nstages
    a_im, a_ex = tab.a_impl, tab.a_expl
    alpha = np.zeros((s, s))
    beta = np.zeros((s, s))
    for i in range(1, s):
        alpha[i, 0] = 1.0
        for j in range(1, i):
            if a_im[i, j] != 0:
                c = a_im[i, j] / a_im[j, j]
                alpha[i, j] += c
                alpha[i] -= c * alpha[j]
                beta[i] -= c * beta[j]
        for j in range(i):
            if a_ex[i, j] != 0:
                beta[i, j] += a_ex[i, j]

    alpha_f = np.zeros(s)
    beta_f = np.zeros(s)
    alpha_f[0] = 1.0
    for i in range(1, s):
        if tab.b_impl[i] != 0:
            c = tab.b_impl[i] / a_im[i, i]
            alpha_f[i] += c
            alpha_f -= c * alpha[i]
            beta_f -= c * beta[i]
    for i in range(s):
        if tab.b_expl[i] != 0:
            beta_f[i] += tab.b_expl[i]
    return alpha, beta, alpha_f, beta_f
