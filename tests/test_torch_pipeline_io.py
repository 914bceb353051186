"""The port's framework-free pipeline modules against the JAX package's:
cache names (utils/io), the namer, the renamer, both CLI parsers, the
native .mc codec (utils/native_io over csrc/mccodec.cpp, built by g++ into
the port's own build/ directory) and the host-side stats helpers.

Cache names and codec bytes must be identical, since each package reads
the other's caches; the stats helpers are copies and must give equal
results on seeded inputs."""

import json

import numpy as np
import pytest

from code_robchar_tpu.exp import cli as jcli
from code_robchar_tpu.exp.namer import ExperimentNamer as JNamer
from code_robchar_tpu.metrics import stats as jstats
from code_robchar_tpu.utils import io as jio
from code_robchar_tpu.utils import native_io as jnative
from code_robchar_tpu.utils import rename as jrename
from code_robchar_tpu_torch.exp import cli
from code_robchar_tpu_torch.exp.namer import ExperimentNamer
from code_robchar_tpu_torch.metrics import stats
from code_robchar_tpu_torch.utils import io, native_io, rename

GRIDS = [np.linspace(0, 0.1, 11), np.linspace(0, 0.1, 3), np.asarray([0.05])]


def test_port_codec_is_its_own_native_library():
    assert native_io.native_available()
    assert native_io._LIB.endswith("code_robchar_tpu_torch/build/"
                                   "libmccodec.so")
    assert native_io._LIB != jnative._LIB


@pytest.mark.parametrize("grid", GRIDS, ids=["11", "3", "one"])
@pytest.mark.parametrize("tn", [None, "0.05", 0.1, "7"])
def test_cache_names_byte_equal(grid, tn):
    store = "experiments/pipeline_x/ppo_spin_7_0-6_c_1000.le"
    assert io.noises_tag(grid) == jio.noises_tag(grid)
    got = io.mc_cache_name(store, tn, 100, grid)
    assert got == jio.mc_cache_name(store, tn, 100, grid)
    assert got.encode() == jio.mc_cache_name(store, tn, 100, grid).encode()
    # the grid as a list gives the same name (np.asarray inside)
    assert io.mc_cache_name(store, tn, 100, list(grid)) == got


def test_namer_and_rename_equal(tmp_path):
    kw = dict(Nspin=7, inspin=0, outspin=6, numcontrollers=1000,
              global_dir=str(tmp_path / "experiments"))
    a, b = ExperimentNamer("exp1", **kw), JNamer("exp1", **kw)
    assert a.home == b.home
    assert a.controller_store() == b.controller_store()
    assert a() == b() and (tmp_path / "experiments" / "exp1").is_dir()
    name = io.mc_cache_name(a.controller_store(), "0.05", 100, GRIDS[0])
    assert rename.sanitize_name(name) == jrename.sanitize_name(name)
    subs = {".": "_", "-": "+"}
    assert rename.sanitize_name(name, subs) == \
        jrename.sanitize_name(name, subs)
    for pkg in ("port", "jax"):
        d = tmp_path / pkg
        d.mkdir()
        (d / "a [0. 1.].mc").write_text("x")
        (d / "plain.mc").write_text("x")
    assert rename.rename_files(str(tmp_path / "port")) == \
        jrename.rename_files(str(tmp_path / "jax"))
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == \
        sorted(p.name for p in (tmp_path / "jax").iterdir())


ARGVS = [
    [],
    ["--nspin", "7", "--outspin", "6", "--num_controllers", "1000",
     "--fid_threshold", "0.1", "--noise_res", "3", "--max_noise", "0.1"],
    ["--exp_name", "e", "--algo_name", "nmplus", "--fid_noisy", "False",
     "--ham_noisy", "no", "--draws", "50", "--respawn_from_checkpoint",
     "true", "--use_fixed_ham", "1", "--records_update_rate", "300",
     "--topo", "ring"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=["defaults", "collect",
                                              "flags"])
def test_cli_parsers_equal(argv):
    got = vars(cli.get_noise_analysis_args(argv))
    assert got == vars(jcli.get_noise_analysis_args(argv))
    assert got["ham_noisy"] is ("no" not in argv)    # defaults to true
    m = ["--bootreps", "7", "--training_noise", "0.05", "--parallel", "t"]
    assert vars(cli.get_mcsim_args(m)) == vars(jcli.get_mcsim_args(m))
    assert vars(cli.get_mcsim_args([])) == vars(jcli.get_mcsim_args([]))
    with pytest.raises(SystemExit):
        cli.get_noise_analysis_args(["--device", "cpu"])


def _awkward(rng, shape):
    """float64 with NaN, +-0, +-inf, subnormals and large exponents."""
    x = rng.normal(size=shape) * 10.0 ** rng.integers(-300, 300, shape)
    flat = x.reshape(-1)
    specials = [np.nan, 0.0, -0.0, np.inf, -np.inf, 5e-324, -2.5e-310,
                1.7976931348623157e308, 1e-320, 0.1, 5.0, -3.0, 1e22]
    flat[:len(specials)] = specials[:flat.size]
    return x


@pytest.mark.parametrize("shape", [(29,), (7, 5), (3, 4, 6), (2, 1, 1)])
def test_native_encoders_write_identical_bytes(shape):
    rng = np.random.default_rng(sum(shape))
    x = np.ascontiguousarray(_awkward(rng, shape))
    got = native_io._encode_native_bytes(x, native_io._load())
    assert got == jnative._encode_native_bytes(x, jnative._load())
    assert native_io.encode_tensor(x) == jnative.encode_tensor(x)
    back = native_io.decode_tensor(got.decode())
    np.testing.assert_array_equal(back, x)                 # NaN-aware
    assert np.array_equal(np.signbit(back), np.signbit(x))  # -0.0 kept


def _tensors(seed=3):
    rng = np.random.default_rng(seed)
    fid = rng.uniform(size=(3, 4, 5))
    fid[:, 2, :] = np.nan                     # a NaN-padded controller
    return {"nmplus": fid, "ppo": _awkward(rng, (2, 3, 4)),
            "lbfgs": rng.normal(size=(3,))}


def _same(a, b):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype == np.float64
        assert a[k].tobytes() == b[k].tobytes(), k       # bit-equal


@pytest.mark.parametrize("sidecar", [True, False], ids=["mcb", "json"])
@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_mc_files_cross_load_bit_equal(tmp_path, monkeypatch, sidecar,
                                       direction):
    writer, reader = (native_io, jnative) if direction == "port_to_jax" \
        else (jnative, native_io)
    for mod in (native_io, jnative):
        monkeypatch.setattr(mod, "SIDECAR", sidecar)
    t = _tensors()
    path = str(tmp_path / "x_tn0.05_br_5_nlvl[0.   0.05 0.1 ].mc")
    writer.dump_mc(t, path)
    assert (tmp_path / (path.split("/")[-1] + ".mcb")).exists() == sidecar
    _same(reader.load_mc(path), t)
    # the JSON body alone, with the sidecar ignored on reload
    monkeypatch.setattr(reader, "SIDECAR", False)
    _same(reader.load_mc(path), t)


def test_both_packages_write_the_same_mc_bytes(tmp_path, monkeypatch):
    for mod in (native_io, jnative):
        monkeypatch.setattr(mod, "SIDECAR", False)
    t = _tensors(5)
    native_io.dump_mc(t, str(tmp_path / "a.mc"))
    jnative.dump_mc(t, str(tmp_path / "b.mc"))
    assert (tmp_path / "a.mc").read_bytes() == \
        (tmp_path / "b.mc").read_bytes()


def test_json_fallback_is_parse_equal(tmp_path, monkeypatch):
    """Without a compiler the codec writes json.dumps bodies: the same
    values on reparse (5.0 is '5.0' there and '5' natively, so the bytes
    differ)."""
    monkeypatch.setattr(native_io, "SIDECAR", False)
    t = _tensors(7)
    native_io.dump_mc(t, str(tmp_path / "native.mc"))
    monkeypatch.setattr(native_io, "_load", lambda: None)
    assert not native_io.native_available()
    native_io.dump_mc(t, str(tmp_path / "json.mc"))
    a = (tmp_path / "native.mc").read_text()
    b = (tmp_path / "json.mc").read_text()
    assert a != b
    ja, jb = json.loads(a), json.loads(b)
    for k in t:
        np.testing.assert_array_equal(np.asarray(ja[k]), np.asarray(jb[k]))
        np.testing.assert_array_equal(np.asarray(jb[k]), t[k])
    # the stdlib parser reads the native '-0' as an int: equal in value,
    # the sign of zero lost (as in the JAX package's fallback)
    fallback = native_io.load_mc(str(tmp_path / "native.mc"))
    for k in t:
        np.testing.assert_array_equal(fallback[k], t[k])
    assert native_io.decode_tensor(b[b.index("["):b.index("]]]") + 3]) \
        .shape == (3, 4, 5)


def test_stats_helpers_equal():
    rng = np.random.default_rng(11)
    x = rng.uniform(size=200)
    for a, b in zip(stats.get_cdf(x), jstats.get_cdf(x)):
        np.testing.assert_array_equal(a, b)
    cdf = stats.get_cdf(x)[0]
    np.testing.assert_array_equal(stats.get_supcdf(cdf),
                                  jstats.get_supcdf(cdf))
    walk = np.cumsum(rng.normal(size=120))
    for obs in (x, walk):
        for bartels in (True, False):
            assert stats.vn_test(obs, 0.95, bartels) == \
                jstats.vn_test(obs, 0.95, bartels)
    with pytest.raises(ValueError):
        stats.vn_test(x[:39])
    ties = np.round(x * 10) / 10
    for v in (x, ties):
        np.testing.assert_array_equal(stats.get_ranks(v),
                                      jstats.get_ranks(v))
        for r in (0.0, 0.05, 0.3):
            np.testing.assert_array_equal(stats.clustered_ranks(v, r),
                                          jstats.clustered_ranks(v, r))
