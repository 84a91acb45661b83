"""``load_serving(path, device=...)`` on the CPU (``engine/serving.py``):
a ``stablehlo`` artifact moved to another device names nothing of its
export device, loads on its own device by name as it does by default, and
a card-exported one is refused without CUDA unless the CPU is asked for;
``aot`` refuses any device but its own. The card's directions (card to
CPU, CPU to card, through the kernels) are in ``tests/test_torch_cuda.py``
and ``chip_smoke.py``.

Config: the flagship at canvas 64x96, narrowed as ``tiny_cfgs``, float32,
random weights from seed 0. Outputs are held to the eager forward exactly
(the same CPU operators run).
"""

import json
import zipfile

import pytest
import torch

from da_detect_tpu_torch.engine.serving import (META_FILE, devices_named,
                                                export_serving, load_serving,
                                                move_program, read_meta)
from da_detect_tpu_torch.entry import entry
from tests.torch_harness import tiny_cfgs

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    _, cfg = tiny_cfgs()
    fn, (model, batch) = entry(device="cpu", seed=0, cfg=cfg)
    ref = fn(model, batch)
    assert int(ref.valid.sum()) > 0
    variables = model.state_dict()
    root = tmp_path_factory.mktemp("serving_device")
    paths = {}
    for fmt in ("stablehlo", "aot"):
        paths[fmt] = str(root / f"{fmt}.pt2")
        export_serving(cfg, model, variables, paths[fmt], fmt=fmt)
    return dict(paths=paths, variables=variables, batch=batch, ref=ref,
                root=root)


def _same(got, want):
    assert all(a.dtype == b.dtype and torch.equal(a, b)
               for a, b in zip(got, want))


def _as_card_export(src: str, dst: str) -> None:
    """``src`` with its metadata saying it was exported on ``cuda:0``."""
    with zipfile.ZipFile(src) as zin, zipfile.ZipFile(dst, "w") as zout:
        for item in zin.infolist():
            data = zin.read(item.filename)
            if item.filename.endswith(f"extra/{META_FILE}"):
                meta = json.loads(data)
                data = json.dumps(dict(meta, device="cuda:0",
                                       platform="gpu")).encode()
            zout.writestr(item, data)


def test_stablehlo_moved_to_meta_names_no_cpu(artifacts):
    """Every constant (the anchors cached at export), every device in a
    node's arguments and every recorded value leaves the CPU."""
    ep = torch.export.load(artifacts["paths"]["stablehlo"])
    assert devices_named(ep) == {"cpu"} and ep.constants
    moved = move_program(ep, CPU, torch.device("meta"))
    assert devices_named(moved) == {"meta"}
    assert all(t.is_meta for t in moved.constants.values())


@pytest.mark.parametrize("fmt", ["stablehlo", "aot"])
def test_load_on_own_device_by_name(artifacts, fmt):
    for device in ("cpu", CPU):
        serving = load_serving(artifacts["paths"][fmt], device=device)
        assert serving.device == CPU
        _same(serving(artifacts["variables"], artifacts["batch"]),
              artifacts["ref"])


@pytest.mark.parametrize("fmt", ["stablehlo", "aot"])
def test_load_on_cuda_raises_without_cuda(artifacts, fmt, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    hint = "device='cpu'" if fmt == "stablehlo" else "fmt='stablehlo'"
    for device in ("cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="no CUDA device") as e:
            load_serving(artifacts["paths"][fmt], device=device)
        assert hint in str(e.value)


def test_card_export_loads_on_the_cpu_when_asked(artifacts, monkeypatch):
    """An artifact recorded as a card export: refused by default on a host
    without CUDA, the refusal pointing at ``device='cpu'``; loaded there
    when asked, its meta then naming the CPU and the export device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = str(artifacts["root"] / "card_stablehlo.pt2")
    _as_card_export(artifacts["paths"]["stablehlo"], path)
    assert read_meta(path)["device"] == "cuda:0"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_serving(path)
    serving = load_serving(path, device="cpu")
    assert serving.device == CPU
    assert serving.meta["exported_on"] == "cuda:0"
    _same(serving(artifacts["variables"], artifacts["batch"]),
          artifacts["ref"])


def test_aot_refuses_another_device(artifacts, monkeypatch):
    """A CPU aot artifact asked onto a card (present, as far as the load
    can tell) is refused before anything runs there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(RuntimeError, match="runs there only") as e:
        load_serving(artifacts["paths"]["aot"], device="cuda")
    assert "fmt='stablehlo'" in str(e.value)
    card = str(artifacts["root"] / "card_aot.pt2")
    _as_card_export(artifacts["paths"]["aot"], card)
    with pytest.raises(RuntimeError, match="runs there only"):
        load_serving(card, device="cpu")


@pytest.mark.parametrize("device", ["meta", "xpu"])
def test_unsupported_device_raises(artifacts, device):
    with pytest.raises(ValueError, match="unsupported device"):
        load_serving(artifacts["paths"]["stablehlo"], device=device)
