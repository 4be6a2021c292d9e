"""Flow-matching samplers: host-side coefficient tables + one step.

Counterpart of wan2gp_tpu/schedulers/base.py (a copy of its numpy table
code).  `make_schedule` computes, in float64 numpy, the sigma/timestep
schedule and every per-step update coefficient; `solver_step` applies one
update from those per-step scalars.  The model predicts the velocity v
with x_sigma = (1 - sigma) x0 + sigma noise, so x0 = x - sigma v.
Solvers: unipc (the WanGP default), dpm++ (order 2, midpoint), and the
first-order euler, causvid (fixed timestep table) and lcm.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Sampler schedule + per-step update coefficients (numpy float32)."""
    name: str
    num_steps: int
    timesteps: np.ndarray = None     # [N] model-facing t values
    sigmas: np.ndarray = None        # [N+1]
    coeffs: Dict[str, np.ndarray] = None

    def per_step(self, i: int) -> Dict[str, float]:
        return {k: float(v[i]) for k, v in self.coeffs.items()}


def _shift_sigma(sigma, shift):
    return shift * sigma / (1.0 + (shift - 1.0) * sigma)


def _lam(sigma):
    """lambda(sigma) = log(alpha) - log(sigma), alpha = 1 - sigma."""
    with np.errstate(divide="ignore"):
        return np.log1p(-sigma) - np.log(sigma)


def _make_first_order(name, sigmas, timesteps, num_steps):
    sig = np.asarray(sigmas, dtype=np.float64)
    dt = sig[1:] - sig[:-1]  # [N]
    return Schedule(name=name, num_steps=num_steps,
                    timesteps=np.asarray(timesteps, dtype=np.float32),
                    sigmas=np.asarray(sig, dtype=np.float32),
                    coeffs={"dt": np.asarray(dt, dtype=np.float32)})


def _euler_schedule(num_steps, shift, num_train_timesteps=1000):
    """linspace(T, 1, N) + [0], timestep shift, last dropped."""
    ts = np.linspace(num_train_timesteps, 1, num_steps, dtype=np.float64)
    ts = np.concatenate([ts, [0.0]])
    ts = _shift_sigma(ts / num_train_timesteps, shift) * num_train_timesteps
    sigmas = ts / num_train_timesteps  # [N+1], last = 0
    return _make_first_order("euler", sigmas, ts[:-1].astype(np.float32),
                             num_steps)


def _causvid_schedule(num_steps, shift=None, num_train_timesteps=1000):
    """Fixed timestep table, sigma = t / 1000, final 0."""
    table = np.array([1000, 934, 862, 756, 603, 410, 250, 140, 74],
                     dtype=np.float64)
    ts = table[:num_steps]
    sigmas = np.concatenate([ts / num_train_timesteps, [0.0]])
    return _make_first_order("causvid", sigmas, ts, num_steps)


def _lcm_schedule(num_steps, shift, num_train_timesteps=1000):
    """Rectified-flow sigma ramp of at most 8 steps; the final sigma is
    not zero."""
    num_steps = min(num_steps, 8)
    t = np.linspace(0.0, 1.0, num_steps + 1, dtype=np.float64)
    sigma_max, sigma_min = 1.0, 0.003 / 1.002
    sigmas = sigma_min + (sigma_max - sigma_min) * (1.0 - t)
    sigmas = _shift_sigma(sigmas, shift)
    ts = sigmas[:-1] * num_train_timesteps
    return _make_first_order("lcm", sigmas, ts, num_steps)


def _flow_sigmas(num_steps, shift, num_train_timesteps):
    """linspace(1 - 1/T .. 0), shifted; timesteps truncated to integers."""
    sigma_max = 1.0 - 1.0 / num_train_timesteps
    sigmas = np.linspace(sigma_max, 0.0, num_steps + 1,
                         dtype=np.float64)[:-1]
    sigmas = _shift_sigma(sigmas, shift)
    ts = np.trunc(sigmas * num_train_timesteps)
    sigmas = np.concatenate([sigmas, [0.0]])
    return sigmas, ts


def _uni_rb(order, rks, hh):
    """UniPC R matrix / b vector (bh2: B_h = expm1(hh))."""
    h_phi_1 = np.expm1(hh)
    B_h = h_phi_1
    h_phi_k = h_phi_1 / hh - 1.0
    R, b = [], []
    fact = 1
    for j in range(1, order + 1):
        R.append(rks ** (j - 1))
        b.append(h_phi_k * fact / B_h)
        fact *= j + 1
        h_phi_k = h_phi_k / hh - 1.0 / fact
    return np.array(R), np.array(b)


def _unipc_schedule(num_steps, shift, num_train_timesteps=1000,
                    solver_order=2):
    """UniPC order <= 3 (predict_x0, bh2) with precomputed coefficients.

      m_i = x_i - sigma[i] * v_i
      corrector (i >= 1): x_i <- Ac*x_{i-1} + Bc*m_{i-1}
          + Cc1*(m_{i-2}-m_{i-1}) + Cc1b*(m_{i-3}-m_{i-1}) + Cc2*(m_i-m_{i-1})
      predictor: x_{i+1} = Ap*x_i + Bp*m_i + Cp*(m_{i-1}-m_i)
          + Cp2*(m_{i-2}-m_i)
    """
    if solver_order not in (1, 2, 3):
        raise NotImplementedError("solver_order must be 1, 2 or 3")
    sigmas, ts = _flow_sigmas(num_steps, shift, num_train_timesteps)
    N = num_steps
    sig = sigmas
    alpha = 1.0 - sig
    lam = _lam(sig)

    Ap = np.zeros(N); Bp = np.zeros(N); Cp = np.zeros(N); Cp2 = np.zeros(N)
    Ac = np.zeros(N); Bc = np.zeros(N)
    Cc1 = np.zeros(N); Cc1b = np.zeros(N); Cc2 = np.zeros(N)

    def order_at(i):
        return min(solver_order, i + 1, N - i)

    for i in range(N):
        op = order_at(i)
        h = lam[i + 1] - lam[i]
        hh = -h
        B_h = np.expm1(hh)
        Ap[i] = sig[i + 1] / sig[i] if sig[i] > 0 else 0.0
        Bp[i] = -alpha[i + 1] * B_h
        if op >= 2:
            rks = np.array([(lam[i - j] - lam[i]) / h
                            for j in range(1, op)] + [1.0])
            if op == 2:
                rhos_p = np.array([0.5])
            else:
                R, b = _uni_rb(op, rks, hh)
                rhos_p = np.linalg.solve(R[:-1, :-1], b[:-1])
            Cp[i] = -alpha[i + 1] * B_h * rhos_p[0] / rks[0]
            if op >= 3:
                Cp2[i] = -alpha[i + 1] * B_h * rhos_p[1] / rks[1]

        if i >= 1:
            oc = order_at(i - 1)
            hc = lam[i] - lam[i - 1]
            hhc = -hc
            B_hc = np.expm1(hhc)
            Ac[i] = sig[i] / sig[i - 1] if sig[i - 1] > 0 else 0.0
            Bc[i] = -alpha[i] * B_hc
            if oc == 1:
                Cc2[i] = -alpha[i] * B_hc * 0.5
            else:
                rks = np.array([(lam[i - 1 - j] - lam[i - 1]) / hc
                                for j in range(1, oc)] + [1.0])
                R, b = _uni_rb(oc, rks, hhc)
                rhos_c = np.linalg.solve(R, b)
                Cc1[i] = -alpha[i] * B_hc * rhos_c[0] / rks[0]
                if oc >= 3:
                    Cc1b[i] = -alpha[i] * B_hc * rhos_c[1] / rks[1]
                Cc2[i] = -alpha[i] * B_hc * rhos_c[-1]

    coeffs = {k: np.asarray(v, dtype=np.float32) for k, v in dict(
        Ap=Ap, Bp=Bp, Cp=Cp, Cp2=Cp2, Ac=Ac, Bc=Bc, Cc1=Cc1, Cc1b=Cc1b,
        Cc2=Cc2, sigma=sig[:-1],
        use_corr=(np.arange(N) > 0).astype(np.float32)).items()}
    return Schedule(name="unipc", num_steps=N,
                    timesteps=np.asarray(ts, dtype=np.float32),
                    sigmas=np.asarray(sig, dtype=np.float32),
                    coeffs=coeffs)


def _dpm_schedule(num_steps, shift, num_train_timesteps=1000):
    """FlowDPM++ multistep, order 2, midpoint.

      m_i = x_i - sigma[i] * v_i
      x_{i+1} = A*x_i + B*m_i + C*(m_i - m_{i-1})
    The first and last steps are first-order (C = 0).
    """
    sigmas = np.linspace(1.0, 0.0, num_steps + 1,
                         dtype=np.float64)[:num_steps]
    sigmas = _shift_sigma(sigmas, shift)
    ts = np.trunc(sigmas * num_train_timesteps)
    sig = np.concatenate([sigmas, [0.0]])
    N = num_steps
    alpha = 1.0 - sig
    lam = _lam(sig)

    A = np.zeros(N); B = np.zeros(N); C = np.zeros(N)
    for i in range(N):
        h = lam[i + 1] - lam[i]
        em1 = np.expm1(-h)
        A[i] = sig[i + 1] / sig[i] if sig[i] > 0 else 0.0
        B[i] = -alpha[i + 1] * em1
        first_order = (i == 0) or (i == N - 1)
        if not first_order:
            r0 = (lam[i] - lam[i - 1]) / h
            C[i] = -alpha[i + 1] * em1 * 0.5 / r0
    coeffs = {k: np.asarray(v, dtype=np.float32) for k, v in dict(
        A=A, B=B, C=C, sigma=sig[:-1]).items()}
    return Schedule(name="dpm++", num_steps=N,
                    timesteps=np.asarray(ts, dtype=np.float32),
                    sigmas=np.asarray(sig, dtype=np.float32),
                    coeffs=coeffs)


_MAKERS = {
    "euler": _euler_schedule,
    "causvid": _causvid_schedule,
    "lcm": _lcm_schedule,
    "unipc": _unipc_schedule,
    "": _unipc_schedule,      # the WanGP default
    "dpm++": _dpm_schedule,
}


def make_schedule(solver: str, num_steps: int, shift: float = 5.0,
                  num_train_timesteps: int = 1000,
                  solver_order: int = 2) -> Schedule:
    if solver not in _MAKERS:
        raise NotImplementedError(f"unsupported solver {solver!r}")
    if solver == "unipc":
        return _unipc_schedule(num_steps, shift, num_train_timesteps,
                               solver_order=solver_order)
    return _MAKERS[solver](num_steps, shift, num_train_timesteps)


def init_solver_state(schedule: Schedule, latents) -> Dict[str, Any]:
    """Solver state carried across steps."""
    z = torch.zeros_like(latents, dtype=torch.float32)
    if schedule.name == "unipc":
        return {"m1": z, "m2": z, "m3": z, "last_x": z}
    if schedule.name == "dpm++":
        return {"m1": z}
    return {}


def solver_step(schedule: Schedule, i: int, coeffs_i: Dict[str, float],
                model_output, x, state: Dict[str, Any]):
    """One update from step-i scalars.  Returns (x_next, state)."""
    name = schedule.name
    c = coeffs_i
    v = model_output.float()
    x = x.float()
    if name in ("euler", "causvid", "lcm"):
        return x + v * c["dt"], state
    if name == "dpm++":
        m = x - c["sigma"] * v
        return c["A"] * x + c["B"] * m + c["C"] * (m - state["m1"]), \
            {"m1": m}
    if name != "unipc":
        raise NotImplementedError(name)
    m = x - c["sigma"] * v
    m1, m2, m3 = state["m1"], state["m2"], state["m3"]
    if c["use_corr"] > 0:
        x = (c["Ac"] * state["last_x"] + c["Bc"] * m1
             + c["Cc1"] * (m2 - m1) + c["Cc1b"] * (m3 - m1)
             + c["Cc2"] * (m - m1))
    x_next = (c["Ap"] * x + c["Bp"] * m + c["Cp"] * (m1 - m)
              + c["Cp2"] * (m2 - m))
    return x_next, {"m1": m, "m2": m1, "m3": m2, "last_x": x}
