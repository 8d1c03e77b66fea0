"""The port stands on its own: no module of src/repro_torch/ nor
chip_smoke.py imports JAX or the JAX package; its configs, the tile
layer's ``TilePolicy`` op classes and the ``PrecisionEnv`` presets
mirror ``repro``'s field for field, as do the training configs
(``OptConfig``, ``DataConfig``, ``TrainLoopConfig``); entry points
refuse to fall back to the CPU when a GPU is asked for and none is
present; options not ported yet raise NotImplementedError, as does a
config the JAX engine does not serve either (qwen2-vl)."""

import ast
import dataclasses
import importlib
import pathlib

import pytest
import torch

from repro import configs as jax_configs
from repro.core import precision as jax_precision
from repro.core import tiles as jax_tiles
from repro.data import pipeline as jax_data
from repro.launch import train as jax_train
from repro.optim import optimizer as jax_opt
from repro_torch import configs
from repro_torch.core import precision, tiles
from repro_torch.data import pipeline as data
from repro_torch.launch import train
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.engine import Engine, EngineConfig, SamplingParams
from repro_torch.models.model import Model
from repro_torch.optim import optimizer as opt

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    bad = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


def test_every_port_module_imports_without_a_gpu():
    for path in PORT_FILES[:-1]:
        rel = path.relative_to(ROOT / "src").with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        importlib.import_module(".".join(parts))


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_configs_mirror_jax_field_for_field(arch):
    mine, ref = configs.get_config(arch), jax_configs.get_config(arch)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert dataclasses.asdict(mine.smoke()) == dataclasses.asdict(ref.smoke())
    assert mine.layer_kinds == ref.layer_kinds


@pytest.mark.parametrize("name", sorted(jax_precision.PRESETS))
def test_precision_presets_mirror_jax_field_for_field(name):
    mine, ref = precision.PRESETS[name], jax_precision.PRESETS[name]
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert mine.significand_bits == ref.significand_bits


@pytest.mark.parametrize("policy", ["DEFAULT_POLICY", "STX_POLICY"])
def test_tile_policy_mirrors_jax_field_for_field(policy):
    """The op-class fields and ``vrp_env``; JAX's ``interpret`` and
    ``stx_block_*`` have no counterpart (the device decides)."""
    assert tiles.OP_CLASSES == jax_tiles.OP_CLASSES
    mine, ref = getattr(tiles, policy), getattr(jax_tiles, policy)
    fields = [f.name for f in dataclasses.fields(mine)]
    assert fields == list(tiles.OP_CLASSES) + ["vrp_env"]
    assert all(getattr(mine, f) == getattr(ref, f) for f in fields)
    dropped = {f.name for f in dataclasses.fields(ref)} - set(fields)
    assert dropped == {"interpret", "stx_block_m", "stx_block_n",
                       "stx_block_k"}


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    cfg = configs.get_config("olmo_1b").smoke()
    with pytest.raises(RuntimeError, match="cuda"):
        Model(cfg)
    model = Model(cfg, device="cpu")
    params = model.init(seed=0)
    with pytest.raises(RuntimeError, match="cuda"):
        Engine(model, params, EngineConfig())


@pytest.mark.parametrize("field,value,item", [
    # a data axis above 1 inside one engine: replicas on submeshes
    ("mesh", Mesh({"data": 2, "model": 2}), "multi-device"),
])
def test_unported_engine_options_raise(field, value, item):
    model = Model(configs.get_config("olmo_1b").smoke(), device="cpu")
    params = model.init(seed=0)
    cfg = dataclasses.replace(EngineConfig(), **{field: value})
    with pytest.raises(NotImplementedError, match=item):
        Engine(model, params, cfg, device="cpu")


@pytest.mark.parametrize("arch", ["whisper_base", "qwen2_vl_2b"])
def test_encdec_serves_and_vlm_is_refused_at_engine(arch):
    """whisper, refused until its slice, builds an ``Engine`` from the
    port's own init and serves a request with encoder features; qwen2-vl
    has no paged decode path, in the port as in JAX, and is refused by
    name."""
    cfg = configs.get_config(arch).smoke()
    model = Model(cfg, device="cpu")
    params = model.init(seed=0)
    if not cfg.enc_dec:
        with pytest.raises(NotImplementedError, match="paged decode"):
            Engine(model, params, EngineConfig(), device="cpu")
        return
    eng = Engine(model, params, EngineConfig(), device="cpu")
    feats = torch.randn((9, cfg.d_model)).numpy()
    out = eng.generate([[1, 2, 3]], SamplingParams(max_tokens=3),
                       encoder_features=[feats])
    st = eng.stats()
    assert len(out[0]) == 3 and st["blocks_used"] == 0
    assert st["cross_arena"]["rows_used"] == 0


@pytest.mark.parametrize("arch", ["xlstm_1_3b", "qwen3_moe_30b_a3b"])
def test_xlstm_and_moe_configs_serve_at_engine(arch):
    """The xLSTM and MoE families, refused until their slice, build an
    ``Engine`` from the port's own init and serve a request."""
    model = Model(configs.get_config(arch).smoke(), device="cpu")
    eng = Engine(model, model.init(seed=0), EngineConfig(), device="cpu")
    out = eng.generate([[1, 2, 3]], SamplingParams(max_tokens=3))
    assert len(out[0]) == 3 and eng.stats()["blocks_used"] == 0


@pytest.mark.parametrize("mine,ref", [
    (opt.OptConfig, jax_opt.OptConfig),
    (data.DataConfig, jax_data.DataConfig),
    (train.TrainLoopConfig, jax_train.TrainLoopConfig),
], ids=["OptConfig", "DataConfig", "TrainLoopConfig"])
def test_training_configs_mirror_jax_field_for_field(mine, ref):
    """Same fields in the same order with the same defaults, but
    ``TrainLoopConfig.ckpt_dir``: JAX's is ``/tmp/repro_ckpt``, the
    port's ``repro_ckpt`` under the process's temp directory."""
    assert [f.name for f in dataclasses.fields(mine)] == \
        [f.name for f in dataclasses.fields(ref)]
    for f, g in zip(dataclasses.fields(mine), dataclasses.fields(ref)):
        if f.name == "ckpt_dir":
            assert pathlib.Path(f.default).name == \
                pathlib.Path(g.default).name
        else:
            assert f.default == g.default, f.name


def test_train_main_raises_without_cuda_and_for_tp():
    """``python -m repro_torch.launch.train`` runs on the card unless
    asked for the CPU: without a GPU ``--device cuda`` (the default)
    raises; ``--tp`` other than 1 names the Multi-device item."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--device", "cuda", "--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--smoke", "--steps", "1"])
    with pytest.raises(NotImplementedError, match="Multi-device"):
        train.main(["--smoke", "--device", "cpu", "--tp", "2"])
