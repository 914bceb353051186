"""The ``mc`` driver and its reference follow the configuration's dtype.

A float32 configuration's inputs, drift and reference draws are the ones
the driver made before it read the dtype, bit for bit.  A float64 copy of
``xx7_0to6`` (built here, not in BENCHMARK.json) is judged at float64: a
sound run on the CPU reads next to nothing, while the float32 control and
kernel 1 computed in float32 part from the reference by far more."""

import time

import numpy as np
import torch

from code_robchar_tpu_torch.ops import chain, cuda_jacobi
from robchar_bench import harness
from robchar_bench.drivers import mc as driver
from robchar_bench.reference import mc as ref
from robchar_bench.reference import physics, threefry

BENCH = harness.load_json(harness.bench_path())
CELL = "mc.xx7_0to6"
SEED = 2**31 + 4242
GAPS = ("rim_gap", "std_gap", "worst_gap")
#: the most a sound float64 run may read on a gap family
SOUND = 1e-9


def _spec(dtype, controllers=None):
    spec = harness.cell_spec(BENCH, CELL)
    spec["config"]["dtype"] = dtype
    if controllers:
        spec["config"]["mc"]["controllers"] = controllers
        spec["mix"]["sample_cells"] = 24
    return spec


def _parent_fidelities(key, n, in_site, out_site, controllers, noises,
                       num_c, bootreps, cells, precision="float64"):
    """reference/mc.fidelities as it was before it took the dtype."""
    l_idx, c_idx = cells[:, 0], cells[:, 1]
    gids = ((l_idx * num_c + c_idx)[:, None] * bootreps
            + np.arange(bootreps)[None, :])
    keys = threefry.fold_in(key, gids)
    z = threefry.normal(threefry.split(keys, 3), n)
    sigma = np.asarray(noises, dtype=np.float32).astype(np.float64)[l_idx]
    z = z * sigma[:, None, None, None]
    x = np.asarray(controllers, dtype=np.float64)[c_idx]
    h = np.zeros(z.shape[:2] + (n, n), dtype=np.complex128)
    i = np.arange(n)
    h[..., i, i] = z[..., 0, :] + x[:, None, :n]
    off = 1.0 + z[..., 1, :n - 1] + 1j * z[..., 2, :n - 1]
    h[..., i[1:], i[:-1]] = off
    h[..., i[:-1], i[1:]] = np.conj(off)
    t = np.broadcast_to(x[:, None, n], h.shape[:2])
    return physics.fidelity(h, t, in_site, out_site, precision)


def test_float32_paths_are_unchanged():
    spec = _spec("float32")
    cfg, mix = spec["config"], spec["mix"]
    n, box, count = cfg["n"], cfg["controller_box"], cfg["mc"]["controllers"]
    rng = np.random.default_rng(SEED)
    ctrl = np.column_stack([rng.uniform(*box["bias"], (count, n)),
                            rng.uniform(*box["time"], count)])
    inputs = driver.inputs(cfg, mix, SEED)
    assert inputs["controllers"].dtype == np.float32
    assert inputs["controllers"].tobytes() == ctrl.astype(np.float32).tobytes()
    assert inputs["noises"].tobytes() == np.asarray(
        cfg["mc"]["noise_levels"], np.float32).tobytes()
    h0 = driver.setup(cfg, mix, SEED, "cpu").program["h0"]
    assert h0.dtype == torch.float32
    assert torch.equal(h0, chain.xx_hamiltonian_real(n, dtype=torch.float32))
    cells = driver.sample(cfg, mix, SEED, 2)[:16]
    key = threefry.fold_in(threefry.key(SEED), int(cells[0, 0]))
    args = (key, n, cfg["in_site"], cfg["out_site"], inputs["controllers"],
            inputs["noises"], count, cfg["mc"]["bootreps"], cells[:, 1:])
    for precision in ("float64", driver.CONTROLS["float32"]):
        want = _parent_fidelities(*args, precision=precision)
        assert ref.fidelities(*args, precision=precision).tobytes() == \
            want.tobytes()
        assert ref.fidelities(*args, precision=precision,
                              dtype="float32").tobytes() == want.tobytes()


def test_float64_inputs_and_drift():
    spec = _spec("float64")
    cfg, mix = spec["config"], spec["mix"]
    inputs = driver.inputs(cfg, mix, SEED)
    f32 = driver.inputs(_spec("float32")["config"], mix, SEED)
    assert inputs["controllers"].dtype == inputs["noises"].dtype == np.float64
    # the same draws, not rounded through float32
    assert (inputs["controllers"].astype(np.float32) ==
            f32["controllers"]).all()
    assert (inputs["controllers"] != f32["controllers"]).any()
    job = driver.setup(cfg, mix, SEED, "cpu")
    assert {v.dtype for k, v in job.program.items() if k != "device"} == \
        {torch.float64}
    assert driver.CONTROLS["float64"] == "float32"


def _run(spec):
    return harness.run_cell(spec, SEED, 0.01, False, "cpu",
                            time.perf_counter(), log=lambda *a: None)


def test_float64_sound_run_reads_next_to_nothing():
    res = _run(_spec("float64", controllers=4))
    assert res["failed"] == 0
    for name in GAPS:
        assert res["checks"][name]["value"] <= SOUND, res["checks"]


def test_float64_control_parts_from_the_reference():
    # the control replaces the program's outputs, so it needs no unit: the
    # cell's own controllers and sample, two units' keys
    spec = _spec("float64")
    cfg, mix = spec["config"], spec["mix"]
    control = driver.readings(cfg, mix, driver.inputs(cfg, mix, SEED),
                              [None, None], control=True)
    assert max(control[name] for name in GAPS) >= 10 * SOUND, control


def test_float64_run_with_kernel_1_in_float32_is_seen(monkeypatch):
    real = cuda_jacobi.fidelity_herm

    def in_float32(ar, ai, t, *args, **kwargs):
        return real(ar.float(), ai.float(), t.float(), *args,
                    **kwargs).to(ar.dtype)

    def widest(res):
        return max(res["checks"][name]["value"] for name in GAPS)

    sound = widest(_run(_spec("float64", controllers=4)))
    monkeypatch.setattr(cuda_jacobi, "fidelity_herm", in_float32)
    # at four random controllers every fidelity is small, and so is every
    # gap: the fault reads 2e-11 to 3e-9 over seeds, a sound run 3e-16
    assert widest(_run(_spec("float64", controllers=4))) > 1000 * sound

