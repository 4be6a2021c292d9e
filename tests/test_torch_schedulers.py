"""Parity of the port's samplers (UniPC, DPM++, Euler, CausVid, LCM) and
guidance with the JAX package (tables exact, trajectories at 1e-5), and
with the reference-executed solver goldens (5e-4, as
tests/test_goldens*.py hold the JAX package)."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from wan2gp_tpu import guidance as jguid
from wan2gp_tpu.models.wan import pipeline as jpipe
from wan2gp_tpu.schedulers import base as jsched
from wan2gp_tpu_torch import guidance
from wan2gp_tpu_torch.models.wan.pipeline import SamplingConfig, plan_phases
from wan2gp_tpu_torch.schedulers import (make_schedule, init_solver_state,
                                         solver_step)

from tests.test_goldens import _load

from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("order,steps,shift", [(1, 4, 3.0), (2, 10, 5.0),
                                               (3, 7, 8.0)])
def test_unipc_tables_match_jax(order, steps, shift):
    s = make_schedule("unipc", steps, shift=shift, solver_order=order)
    j = jsched.make_schedule("unipc", steps, shift=shift, solver_order=order)
    np.testing.assert_array_equal(s.timesteps, np.asarray(j.timesteps))
    np.testing.assert_array_equal(s.sigmas, np.asarray(j.sigmas))
    assert set(s.coeffs) == set(j.coeffs)
    for k in s.coeffs:
        np.testing.assert_array_equal(s.coeffs[k], np.asarray(j.coeffs[k]))


def _run(sched, step, init, x0, outputs, to, back):
    x = to(x0)
    state = init(sched, x)
    for i in range(sched.num_steps):
        ci = ({k: float(v[i]) for k, v in sched.coeffs.items()}
              if isinstance(x, torch.Tensor)
              else {k: v[i] for k, v in sched.coeffs.items()})
        x, state = step(sched, i, ci, to(outputs[i]), x, state)
    return back(x)


def test_unipc_trajectory_matches_jax():
    rng = np.random.default_rng(0)
    x0 = rng.standard_normal((2, 16, 3, 4, 4)).astype(np.float32)
    outs = rng.standard_normal((6, 2, 16, 3, 4, 4)).astype(np.float32)
    s = make_schedule("unipc", 6, solver_order=3)
    j = jsched.make_schedule("unipc", 6, solver_order=3)
    got = _run(s, solver_step, init_solver_state, x0, outs,
               torch.from_numpy, lambda t: t.numpy())
    ref = _run(j, jsched.solver_step, jsched.init_solver_state, x0, outs,
               jnp.asarray, np.asarray)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_golden_unipc_trace():
    g = _load("unipc_trace.npz")
    n, shift = int(g["n_steps"]), float(g["shift"])
    for order, key in ((2, "x_order2"), (3, "x_order3")):
        sched = make_schedule("unipc", n, shift=shift, solver_order=order)
        np.testing.assert_allclose(sched.sigmas, g["sigmas"], rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(sched.timesteps, g["timesteps"], atol=0)
        x = _run(sched, solver_step, init_solver_state, g["x0"],
                 g["outputs"], lambda a: torch.from_numpy(
                     np.asarray(a, np.float32)), lambda t: t.numpy())
        np.testing.assert_allclose(x, g[key], rtol=5e-4, atol=5e-4)


def test_golden_unipc_ref_trace():
    g = _load("unipc_ref_trace.npz")
    for order in (2, 3):
        sched = make_schedule("unipc", 8, shift=5.0, solver_order=order)
        np.testing.assert_allclose(sched.timesteps.astype(np.float64),
                                   g[f"timesteps_o{order}"], rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(
            sched.sigmas.astype(np.float64),
            g[f"sigmas_o{order}"][:len(sched.sigmas)], rtol=1e-6, atol=1e-6)
        x = torch.from_numpy(np.asarray(g["x0"], np.float32))
        state = init_solver_state(sched, x)
        traj = []
        for i in range(8):
            t = float(sched.timesteps[i])
            v = 0.3 * x * np.float32(np.cos(t / 250.0)) - 0.1
            x, state = solver_step(sched, i, sched.per_step(i), v, x, state)
            traj.append(x.numpy())
        np.testing.assert_allclose(np.stack(traj), g[f"traj_o{order}"],
                                   rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("solver,steps,shift", [
    ("dpm++", 7, 5.0), ("euler", 6, 3.0), ("causvid", 9, 8.0),
    ("lcm", 10, 5.0), ("", 5, 5.0)])
def test_other_solver_tables_match_jax(solver, steps, shift):
    s = make_schedule(solver, steps, shift=shift)
    j = jsched.make_schedule(solver, steps, shift=shift)
    assert (s.name, s.num_steps) == (j.name, j.num_steps)
    np.testing.assert_array_equal(s.timesteps, np.asarray(j.timesteps))
    np.testing.assert_array_equal(s.sigmas, np.asarray(j.sigmas))
    assert set(s.coeffs) == set(j.coeffs)
    for k in s.coeffs:
        np.testing.assert_array_equal(s.coeffs[k], np.asarray(j.coeffs[k]))


@pytest.mark.parametrize("solver", ["dpm++", "euler", "causvid", "lcm"])
def test_other_solver_trajectories_match_jax(solver):
    rng = np.random.default_rng(1)
    x0 = rng.standard_normal((2, 16, 3, 4, 4)).astype(np.float32)
    outs = rng.standard_normal((5, 2, 16, 3, 4, 4)).astype(np.float32)
    s = make_schedule(solver, 5)
    j = jsched.make_schedule(solver, 5)
    assert set(init_solver_state(s, torch.zeros(1))) == set(
        jsched.init_solver_state(j, jnp.zeros(1)))
    got = _run(s, solver_step, init_solver_state, x0, outs,
               torch.from_numpy, lambda t: t.numpy())
    ref = _run(j, jsched.solver_step, jsched.init_solver_state, x0, outs,
               jnp.asarray, np.asarray)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def _ref_velocity_trace(name, n, shift, x0):
    """The reference-side generator's fake velocity, step by step."""
    sched = make_schedule(name, n, shift=shift)
    x = torch.from_numpy(np.asarray(x0, np.float32))
    state = init_solver_state(sched, x)
    traj = []
    for i in range(n):
        t = float(sched.timesteps[i])
        v = 0.3 * x * np.float32(np.cos(t / 250.0)) - 0.1
        x, state = solver_step(sched, i, sched.per_step(i), v, x, state)
        traj.append(x.numpy())
    return sched, np.stack(traj)


@pytest.mark.parametrize("name,golden,n,shift", [
    ("dpm++", "dpm_ref_trace.npz", 8, 5.0),
    ("causvid", "flowmatch_ref_trace.npz", 9, 8.0)])
def test_golden_ref_traces(name, golden, n, shift):
    g = _load(golden)
    sched, traj = _ref_velocity_trace(name, n, shift, g["x0"])
    np.testing.assert_allclose(sched.timesteps.astype(np.float64),
                               np.asarray(g["timesteps"], np.float64),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(traj, g["traj"], rtol=5e-4, atol=5e-4)


def test_golden_lcm_trace():
    g = _load("lcm_trace.npz")
    n, shift = int(g["n_steps"]), float(g["shift"])
    sched = make_schedule("lcm", n, shift=shift)
    np.testing.assert_allclose(sched.sigmas, g["sigmas"], rtol=1e-5,
                               atol=1e-6)
    x = _run(sched, solver_step, init_solver_state, g["x0"], g["outputs"],
             lambda a: torch.from_numpy(np.asarray(a, np.float32)),
             lambda t: t.numpy())
    np.testing.assert_allclose(x, g["x_final"], rtol=5e-4, atol=5e-4)


def test_unknown_solver_raises():
    with pytest.raises(NotImplementedError):
        make_schedule("heun", 4)


@pytest.mark.parametrize("use_alpha", [False, True])
def test_cfg_combine_matches_jax(use_alpha):
    rng = np.random.default_rng(1)
    c, u = (rng.standard_normal((2, 16, 2, 4, 4)).astype(np.float32)
            for _ in range(2))
    got = guidance.cfg_combine(torch.from_numpy(c), torch.from_numpy(u),
                               4.5, use_alpha)
    ref = jguid.cfg_combine(jnp.asarray(c), jnp.asarray(u), 4.5, use_alpha)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_apg_update_matches_jax():
    rng = np.random.default_rng(2)
    d, p, buf = (rng.standard_normal((2, 16, 2, 4, 4)).astype(np.float32)
                 * 20 for _ in range(3))
    g, nb = guidance.apg_update(torch.from_numpy(d), torch.from_numpy(p),
                                torch.from_numpy(buf))
    jg, jnb = jguid.apg_update(jnp.asarray(d), jnp.asarray(p),
                               jnp.asarray(buf))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(nb.numpy(), np.asarray(jnb), rtol=1e-5,
                               atol=1e-5)
    assert guidance.apg_init((2, 3)).shape == (2, 3)


@pytest.mark.parametrize("phases,t1,t2", [(1, 0, 0), (2, 600, 0),
                                          (3, 800, 300)])
def test_plan_phases_matches_jax(phases, t1, t2):
    kw = dict(guide_scale=5.0, guide2_scale=3.0, guide3_scale=1.0,
              guide_phases=phases, switch_threshold=t1,
              switch2_threshold=t2, steps=10)
    ts = make_schedule("unipc", 10).timesteps
    for expert2 in (False, True):
        assert plan_phases(ts, SamplingConfig(**kw), expert2) == \
            jpipe.plan_phases(ts, jpipe.SamplingConfig(**kw), expert2)
