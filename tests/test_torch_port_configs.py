"""The port's configs vs the JAX package: the Config fields, the 147 scene
presets, the reference `.gin` / `.txt` experiment files, `config_file_keys`,
`cli/export_configs.py` and the CLI's `--scene` / `--list-scenes`
resolution. The gin and txt inputs are the fixtures of
tests/test_legacy_configs.py. Only the JAX Config's `llffhold` is left out
of the port's (nothing reads it): files and overrides naming it are
skipped with a warning.
"""

import dataclasses
import json
import os
import sys
import types

import pytest

from consistentnerf_tpu.cli import common as jcommon
from consistentnerf_tpu.cli import export_configs as jexport
from consistentnerf_tpu.configs import Config as JaxConfig
from consistentnerf_tpu.configs import config_file_keys as jax_file_keys
from consistentnerf_tpu.configs import load_config as jax_load
from consistentnerf_tpu.configs import scenes as jscenes
from consistentnerf_tpu_torch import configs
from consistentnerf_tpu_torch.cli import common, export_configs
from consistentnerf_tpu_torch.configs import legacy, scenes
from consistentnerf_tpu_torch.train import loop
from torch_port_shared import _one_torch_thread  # noqa: F401

sys.path.insert(0, os.path.dirname(__file__))
from test_legacy_configs import LEGO_TXT, SCAN114_GIN  # noqa: E402

PORT_ONLY_MISSING = {"llffhold"}


def _asdict(cfg) -> dict:
    d = dataclasses.asdict(cfg)
    d.pop("llffhold", None)
    return d


def _write(tmp_path, name, text):
    path = tmp_path / name
    path.write_text(text)
    return str(path)


def test_config_has_every_jax_field_with_its_default():
    jf = {f.name: f for f in dataclasses.fields(JaxConfig)}
    pf = {f.name: f for f in dataclasses.fields(configs.Config)}
    assert set(jf) - set(pf) == PORT_ONLY_MISSING
    assert set(pf) <= set(jf)
    assert _asdict(configs.Config()) == _asdict(JaxConfig())
    assert configs.UNREAD == PORT_ONLY_MISSING


FAMILIES = {
    "vanilla_blender": lambda n: n.endswith("view") and n.split("_")[0]
    in jscenes.BLENDER_SCENES,
    "vanilla_llff": lambda n: n.endswith("view") and n.split("_")[0]
    in jscenes.LLFF_SCENES,
    "vanilla_dtu": lambda n: n.startswith("dtu_"),
    "regnerf3": lambda n: n.startswith("regnerf3_"),
    "mipnerf3": lambda n: n.startswith("mipnerf3_"),
    "synthetic": lambda n: n.startswith("synthetic_"),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_presets_match_jax(family):
    names = [n for n in jscenes.list_scenes() if FAMILIES[family](n)]
    assert names
    for name in names:
        assert _asdict(scenes.get_scene_config(name)) == _asdict(
            jscenes.get_scene_config(name)), name


def test_preset_registry_and_unknown_name():
    assert scenes.list_scenes() == jscenes.list_scenes()
    assert len(scenes.list_scenes()) == 147
    assert scenes.registry().keys() == jscenes.registry().keys()
    with pytest.raises(KeyError, match="close matches"):
        scenes.get_scene_config("fern_4view")


@pytest.mark.parametrize("kind", ["gin", "txt", "gin_minimal"])
def test_reference_files_load_as_in_jax(tmp_path, kind):
    text, name = {"gin": (SCAN114_GIN, "scan114_3.gin"),
                  "txt": (LEGO_TXT, "lego.txt"),
                  "gin_minimal": ('Config.dataset_loader = "blender"\n'
                                  'Config.blender_scene = "lego"\n'
                                  'Config.data_dir = "data/nerf_synthetic"\n'
                                  "Config.flow_loss_mult = 0.0\n",
                                  "minimal.gin")}[kind]
    path = _write(tmp_path, name, text)
    for overrides in ([], ["N_rand=4096", "ss_loss=true"]):
        got = configs.load_config(path, overrides)
        assert _asdict(got) == _asdict(jax_load(path, overrides))
    assert configs.config_file_keys(path) == jax_file_keys(path)
    from consistentnerf_tpu.configs import legacy as jlegacy

    fn = "gin_overrides" if name.endswith(".gin") else "txt_overrides"
    assert getattr(legacy, fn)(text) == getattr(jlegacy, fn)(text)


def test_json_of_a_full_jax_config_loads(tmp_path):
    """A JSON file of every JAX field (once refused for the 39 the port
    lacked) loads; its llffhold is skipped with a warning."""
    jcfg = jscenes.get_scene_config("regnerf3_dtu_scan114").replace(
        llffhold=4, ss_loss=True, gc_every=5)
    path = str(tmp_path / "full.json")
    jcfg.save(path)
    with pytest.warns(UserWarning, match="llffhold"):
        got = configs.load_config(path)
    assert json.loads(got.to_json()) == {
        k: v for k, v in json.loads(jcfg.to_json()).items()
        if k != "llffhold"}
    assert configs.config_file_keys(path) == jax_file_keys(path)
    with pytest.warns(UserWarning, match="llffhold"):
        txt = _write(tmp_path, "h.txt", "llffhold = 8\nN_rand = 512\n")
        assert configs.load_config(txt).N_rand == 512
    with pytest.warns(UserWarning, match="llffhold"):
        assert configs.load_config(None, ["llffhold=8"]) == configs.Config()
    with pytest.raises(KeyError):
        configs.load_config(None, ["bogus=1"])
    saved = str(tmp_path / "port.json")
    got.save(saved)
    assert _asdict(jax_load(saved)) == _asdict(got)


def test_export_configs_matches_jax(tmp_path, capsys):
    export_configs.main([str(tmp_path / "port")])
    jexport.main([str(tmp_path / "jax")])
    out = capsys.readouterr().out
    assert out.count("wrote 147 config files") == 2

    def tree(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    files = tree(tmp_path / "port")
    assert files == tree(tmp_path / "jax") and len(files) == 147
    for rel in files:
        a = (tmp_path / "port" / rel).read_text()
        b = json.loads((tmp_path / "jax" / rel).read_text())
        b.pop("llffhold")
        assert json.loads(a) == b, rel
    fern = configs.load_config(str(tmp_path / "port" / "configs_3view"
                                   / "fern.json"))
    assert fern.to_json() == scenes.get_scene_config("fern_3view").to_json()


def _args(argv, parser):
    return parser.parse_args(argv)


def test_list_scenes_prints_what_jax_prints(capsys):
    for mod in (common, jcommon):
        with pytest.raises(SystemExit) as e:
            mod.resolve_config(_args(["--list-scenes"],
                                     mod.make_parser("x")))
        assert e.value.code == 0
    out = capsys.readouterr().out.splitlines()
    assert out[:147] == out[147:] == jscenes.list_scenes()


@pytest.mark.parametrize("argv", [
    ["--scene", "fern_3view", "--set", "N_rand=1024"],
    ["--scene", "regnerf3_dtu_scan114", "--config", "CFG", "--set",
     "total_iters=100"],
    ["--config", "CFG", "--set", "lrate=0.001"],
    ["--config", "TXT", "--num-steps", "40"],
    ["--scene", "synthetic_pol_mip", "--num-steps", "300"],
])
def test_resolve_config_and_explicit_keys_match_jax(tmp_path, argv):
    """--scene, then --set (a --config beside it is ignored, as in JAX);
    explicit keys count the file's keys, not the preset's; the schedule
    horizon follows --num-steps where it is not explicit."""
    gin = _write(tmp_path, "scan114_3.gin", SCAN114_GIN)
    txt = _write(tmp_path, "lego.txt", LEGO_TXT)
    argv = [gin if a == "CFG" else txt if a == "TXT" else a for a in argv]
    got = []
    for mod in (common, jcommon):
        p = mod.make_parser("x")
        p.add_argument("--num-steps", type=int, default=None)
        args = p.parse_args(argv)
        cfg = mod.resolve_config(args)
        cfg = mod.reconcile_schedule_horizon(cfg, args)
        got.append((_asdict(cfg), mod.explicit_keys(args)))
    assert got[0] == got[1]


def test_multi_device_fields_raise_where_jax_reads_them(tmp_path):
    """resolve_config reads the multi-process fields, as the JAX one does
    (an incomplete set raises before any connection is tried), and train()
    reads mesh_shape (a shape that does not hold the world size raises);
    tests/test_torch_port_parallel.py runs them."""
    p = common.make_parser("x")
    args = p.parse_args(["--set", "num_processes=2", "--set",
                         "coordinator_address=localhost:1234"])
    with pytest.raises(ValueError, match="process_id"):
        common.resolve_config(args)
    cfg = configs.Config(mesh_shape=[2], dataset_type="synthetic")
    with pytest.raises(ValueError, match="the group has 1"):
        loop.train(cfg, types.SimpleNamespace(), device="cpu")


def test_skipped_housekeeping_is_named():
    """The loop's housekeeping is ported (`train/loop.py`), so it skips
    none: the fields keep the JAX defaults (TensorBoard and gc_every on,
    a gin file's seeded train_render_every 2000), and the profiler's
    window is the JAX loop's, steps start+1 ... start+profile_steps."""
    assert not hasattr(loop, "skipped_housekeeping")
    cfg = configs.Config()
    jcfg = JaxConfig()
    for k in ("use_tensorboard", "gc_every", "profile_steps",
              "train_render_every", "profile_dir"):
        assert getattr(cfg, k) == getattr(jcfg, k), k
    assert (cfg.use_tensorboard, cfg.gc_every) == (True, 10000)
    gin = configs.Config(**legacy._REGNERF_BASE)
    assert gin.train_render_every == 2000
    prof = loop.StepProfiler(cfg.replace(profile_steps=3), 5, "cpu")
    assert (prof.first, prof.last) == (6, 8)
    assert prof.out_dir.endswith("profile")
    assert not loop.StepProfiler(cfg, 5, "cpu").on