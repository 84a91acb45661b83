"""Serving export (port of ``da_detect_tpu/engine/serving.py``).

Production serving wants the eval forward built ahead of time, not traced
from model code in the serving process. ``export_serving`` exports the
weight-agnostic eval function ``(variables, ImageBatch) -> Detections[...]``
with ``torch.export`` and writes one ``torch.export.save`` file; its
metadata rides in the file's ``extra_files`` (no pickle). The variables are
a name -> tensor dict with the keys of the model's ``state_dict()``; the
program is a ``torch.func.functional_call`` of the model on them and holds
no parameter or buffer, so one artifact serves every checkpoint of the
architecture.

The eval forward is traced with ``impl="cuda"``: NMS, ROIAlign and the row
gathers are the operators of ``ops/library.py``, one node a kernel launch,
whose CUDA implementations launch the hand-written kernels and whose CPU
implementations run the plain versions. The JAX package exports in a
worker process (``engine/_serving_worker.py``: XLA:CPU mis-serializes an
executable compiled in a process with earlier compilations); this export
runs in the caller's process and has no such worker.

* ``fmt="stablehlo"``: the saved ``ExportedProgram``. It is free of model
  code (loading it imports the operators' registrations, never
  ``models/``) and loads on either device: on the one it was exported on
  by default, on another with ``load_serving(path, device=...)``, which
  moves the program there (``torch.export.passes.move_to_device_pass``:
  its constants, such as the anchors cached on the export device, and
  every device named in its graph). The operators dispatch on their
  inputs' device, so a program exported on the CPU launches the
  hand-written kernels on the card, and one exported on the card runs
  their plain versions on the CPU. Inputs on another device than the one
  loaded to raise.
* ``fmt="aot"``: the same program bound to the device it was exported on
  and the device kind it records (platform, device name, compute
  capability, device count, torch and CUDA versions), as the JAX
  package's ``aot`` executable is; ``load_serving`` refuses another
  device, and another kind unless ``allow_device_mismatch=True``. On a
  CUDA device the load warms the
  program up and captures it as one CUDA graph over static input buffers;
  a call copies the variables and the batch into them, replays the graph
  (the same kernels eager launches, the hand-written ones included) and
  returns clones of the outputs. On the CPU, where there is no graph, it
  runs the program as ``stablehlo`` does.

Images cross the boundary as the eager model takes them: [B, 3, H, W] in
channels-last memory, float32 normalized or raw uint8 pixels
(``image_dtype``), normalized inside the program. The batch crosses as its
four tensors and the variables as a list in the recorded names' order (the
JAX package's flat leaf tuples), so the artifact needs no pytree
registration.
"""

from __future__ import annotations

import json
import zipfile

import torch

from ..ops import library  # noqa: F401  (registers the operators)
from ..structures.detections import Detections
from ..structures.image_batch import ImageBatch
from ..utils.env import reference_numerics

_MAGIC = "da_detect_tpu_torch.serving/v1"
META_FILE = "serving_meta.json"
FORMATS = ("aot", "stablehlo")
# eager runs of the program on the capture stream before the CUDA graph is
# captured (the libraries' handles and workspaces are made there)
WARMUP_RUNS = 2


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _eval_kwargs(with_masks: bool, with_keypoints: bool) -> dict:
    if with_masks and with_keypoints:
        # one head an artifact: the exporter must not guess which one
        raise ValueError("with_masks and with_keypoints are mutually "
                         "exclusive — export one artifact per head")
    return dict(impl="cuda", with_masks=with_masks,
                with_keypoints=with_keypoints)


def batch_spec(cfg, batch_size: int = 1, image_dtype=torch.float32,
               device="meta") -> ImageBatch:
    """The fixed eval canvas batch as empty tensors on ``device`` (default
    ``meta``: shapes and dtypes only). Images [B, 3, H, W] channels-last.

    ``image_dtype`` uint8 exports a raw-pixel server: clients ship 1 byte a
    pixel and the exported program normalizes on the device
    (``ImageBatch.normalized``)."""
    from ..data.transforms import canvas_for

    h, w = canvas_for(cfg, is_train=False)
    b = batch_size
    return ImageBatch(
        images=torch.empty((b, 3, h, w), dtype=image_dtype, device=device,
                           memory_format=torch.channels_last),
        sizes=torch.empty((b, 2), dtype=torch.int32, device=device),
        orig_sizes=torch.empty((b, 2), dtype=torch.int32, device=device),
        is_source=torch.empty((b,), dtype=torch.bool, device=device))


class _Program(torch.nn.Module):
    """The eval forward over flat inputs: (variables in ``names``' order,
    images, sizes, orig_sizes, is_source) -> the output tensors. The model
    is held outside the module tree, so the export lifts none of its
    parameters or buffers."""

    def __init__(self, model, names, kwargs):
        super().__init__()
        self._model = (model,)
        self.names = list(names)
        self.kwargs = kwargs

    def forward(self, params, images, sizes, orig_sizes, is_source):
        batch = ImageBatch(images, sizes, orig_sizes, is_source)
        out = torch.func.functional_call(
            self._model[0], dict(zip(self.names, params)), (batch,),
            self.kwargs, strict=True)
        dets, extra = out if isinstance(out, tuple) \
            and not isinstance(out, Detections) else (out, None)
        return tuple(dets) + (() if extra is None else (extra,))


def device_record(device: torch.device) -> dict:
    """What an ``aot`` artifact is bound to, for ``device``."""
    if device.type == "cuda":
        major, minor = torch.cuda.get_device_capability(device)
        return dict(platform="gpu",
                    device_kind=torch.cuda.get_device_name(device),
                    capability=f"{major}.{minor}",
                    num_devices=torch.cuda.device_count(),
                    torch_version=torch.__version__,
                    cuda_version=torch.version.cuda)
    return dict(platform=device.type, device_kind=device.type,
                capability=None, num_devices=1,
                torch_version=torch.__version__,
                cuda_version=torch.version.cuda)


def export_serving(cfg, model, variables: dict, out_path: str, *,
                   fmt: str = "aot", batch_size: int = 1,
                   with_masks: bool = False, with_keypoints: bool = False,
                   image_dtype=torch.float32) -> dict:
    """Export the eval forward of ``model`` to ``out_path``; returns the
    artifact's metadata.

    ``variables`` (the model's ``state_dict()`` names, on one device) give
    the shapes, dtypes and device the artifact takes; the exported
    function still takes the weights as its first argument. The model is
    traced through the kernels' operators (``impl="cuda"``) on that
    device; its eager calls before and after are not changed."""
    if fmt not in FORMATS:
        raise ValueError(f"unknown serving format {fmt!r}")
    kwargs = _eval_kwargs(with_masks, with_keypoints)
    names = list(variables)
    params = [variables[n].detach() for n in names]
    device = params[0].device
    if any(p.device != device for p in params):
        raise ValueError("export_serving: the variables must lie on one "
                         "device")
    spec = batch_spec(cfg, batch_size, image_dtype, device)
    h, w = spec.images.shape[2:]
    example = (params, spec.images.zero_(),
               torch.tensor([[h, w]] * batch_size, dtype=torch.int32,
                            device=device),
               torch.tensor([[h, w]] * batch_size, dtype=torch.int32,
                            device=device),
               torch.ones((batch_size,), dtype=torch.bool, device=device))
    program = _Program(model, names, kwargs)
    anchors = dict(model._anchors)
    try:
        with torch.no_grad():
            # one eager run puts the anchors of the canvas's feature shapes
            # in the model's cache on the device: the trace then takes them
            # as constants there (made in the trace, they would be host
            # constants copied to the device in every request, and a copy
            # from pageable host memory cannot enter a CUDA graph)
            program(*example)
            ep = torch.export.export(program, example, strict=False)
    finally:
        # the trace must leave no traced anchors in the model's cache
        model._anchors = anchors
    if ep.state_dict:
        raise RuntimeError("serving export lifted parameters "
                           f"{sorted(ep.state_dict)[:5]}: the artifact must "
                           "hold no weights")
    # torch.export keeps the example inputs for a save: they are weights
    ep.example_inputs = None
    outputs = "masks" if with_masks else "keypoints" if with_keypoints \
        else "detections"
    meta = dict(
        magic=_MAGIC, format=fmt, canvas=[int(h), int(w)],
        batch_size=batch_size, with_masks=with_masks,
        with_keypoints=with_keypoints,
        image_dtype=_dtype_name(image_dtype), outputs=outputs,
        variables=[[n, list(p.shape), _dtype_name(p.dtype)]
                   for n, p in zip(names, params)],
        device=str(device), **device_record(device))
    torch.export.save(ep, out_path, extra_files={META_FILE: json.dumps(meta)})
    return meta


def read_meta(path: str) -> dict:
    """The metadata of an artifact, read without loading its program."""
    with zipfile.ZipFile(path) as z:
        name = next((n for n in z.namelist()
                     if n.endswith(f"extra/{META_FILE}")), None)
        if name is None:
            raise ValueError(f"{path} is not a da_detect_tpu_torch serving "
                             "artifact")
        meta = json.loads(z.read(name))
    if meta.get("magic") != _MAGIC:
        raise ValueError(f"{path} is not a da_detect_tpu_torch serving "
                         "artifact")
    return meta


class _GraphedProgram:
    """The program captured as one CUDA graph over static inputs (``aot``
    on a CUDA device)."""

    def __init__(self, module, meta: dict, device: torch.device):
        self.params = [torch.zeros(shape, dtype=getattr(torch, dtype),
                                   device=device)
                       for _, shape, dtype in meta["variables"]]
        spec_b, (h, w) = meta["batch_size"], meta["canvas"]
        image_dtype = getattr(torch, meta["image_dtype"])
        self.batch = [
            torch.empty((spec_b, 3, h, w), dtype=image_dtype, device=device,
                        memory_format=torch.channels_last).zero_(),
            torch.tensor([[h, w]] * spec_b, dtype=torch.int32, device=device),
            torch.tensor([[h, w]] * spec_b, dtype=torch.int32, device=device),
            torch.ones((spec_b,), dtype=torch.bool, device=device)]
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.no_grad():
            with torch.cuda.stream(stream):
                for _ in range(WARMUP_RUNS):
                    module(self.params, *self.batch)
            torch.cuda.current_stream(device).wait_stream(stream)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, stream=stream):
                self.outputs = module(self.params, *self.batch)
        torch.cuda.synchronize(device)

    def __call__(self, params, *batch):
        torch._foreach_copy_(self.params, params)
        for dst, src in zip(self.batch, batch):
            dst.copy_(src)
        self.graph.replay()
        # the next replay overwrites the graph's own outputs
        return tuple(o.clone() for o in self.outputs)


class ServingModel:
    """A loaded serving artifact: call as ``serving(variables, batch)``,
    the contract of the eager ``model(batch)`` with the weights passed in.
    Returns ``Detections``, or (``Detections``, masks or keypoints)."""

    def __init__(self, call, meta: dict):
        self._call = call
        self.meta = meta
        self.device = torch.device(meta["device"])
        self._names = [n for n, _, _ in meta["variables"]]
        self._specs = {n: (tuple(s), getattr(torch, d))
                       for n, s, d in meta["variables"]}
        b, (h, w) = meta["batch_size"], meta["canvas"]
        self._batch_specs = dict(
            images=((b, 3, h, w), getattr(torch, meta["image_dtype"])),
            sizes=((b, 2), torch.int32), orig_sizes=((b, 2), torch.int32),
            is_source=((b,), torch.bool))

    def _check(self, variables: dict, batch: ImageBatch) -> None:
        got = {n: (tuple(v.shape), v.dtype) for n, v in variables.items()}
        if got != self._specs:
            names = sorted(set(got) ^ set(self._specs))
            shapes = sorted(n for n in set(got) & set(self._specs)
                            if got[n] != self._specs[n])
            raise ValueError(
                "variables structure does not match the exported "
                f"architecture: names only on one side {names[:5]}, "
                f"shapes or dtypes differing {shapes[:5]}")
        for field, spec in self._batch_specs.items():
            x = getattr(batch, field)
            if (tuple(x.shape), x.dtype) != spec:
                raise ValueError(
                    f"batch structure does not match the export: {field} "
                    f"is {x.dtype} {tuple(x.shape)}, the artifact takes "
                    f"{spec[1]} {spec[0]}")
        tensors = [batch.images, batch.sizes, batch.orig_sizes,
                   batch.is_source, *variables.values()]
        if any(t.device != self.device for t in tensors):
            raise ValueError(
                f"the artifact runs on {self.device} (where it was "
                f"loaded); got inputs on "
                f"{sorted({str(t.device) for t in tensors})}")

    def __call__(self, variables: dict, batch: ImageBatch):
        self._check(variables, batch)
        params = [variables[n] for n in self._names]
        with torch.no_grad():
            out = self._call(params, batch.images, batch.sizes,
                             batch.orig_sizes, batch.is_source)
        dets = Detections(*out[:4])
        return dets if self.meta["outputs"] == "detections" \
            else (dets, out[4])


def _load_device(device, recorded: torch.device, path: str,
                 fmt: str) -> torch.device:
    """The device ``load_serving`` puts the program on: ``device``, or the
    recorded one; a CUDA device needs one in this process (no fallback)."""
    target = recorded if device is None else torch.device(device)
    if target.type not in ("cpu", "cuda"):
        raise ValueError(f"load_serving: unsupported device {target}")
    if target.type == "cuda":
        if not torch.cuda.is_available():
            hint = ("load it on the CPU with load_serving(path, "
                    "device='cpu')" if fmt == "stablehlo" else
                    "an aot artifact runs on its own device only; export "
                    "fmt='stablehlo' to load it elsewhere")
            raise RuntimeError(f"{path} would run on {target} and this "
                               f"process has no CUDA device: {hint}")
        if target.index is None:
            target = torch.device("cuda", torch.cuda.current_device())
        if target.index >= torch.cuda.device_count():
            raise RuntimeError(f"load_serving: no device {target} in this "
                               f"process ({torch.cuda.device_count()} CUDA "
                               "devices)")
    return target


def devices_named(ep) -> set:
    """Every device an exported program names: its state and constants'
    tensors, the devices in its graph nodes' arguments and the tensors of
    their recorded values."""
    found = {str(t.device) for t in (*ep.state_dict.values(),
                                     *ep.constants.values())
             if isinstance(t, torch.Tensor)}

    def walk(v):
        if isinstance(v, torch.device):
            found.add(str(v))
        elif isinstance(v, torch.Tensor):
            found.add(str(v.device))
        elif isinstance(v, (tuple, list)):
            for x in v:
                walk(x)
        elif isinstance(v, dict):
            for x in v.values():
                walk(x)

    for m in ep.graph_module.modules():
        if isinstance(m, torch.fx.GraphModule):
            for node in m.graph.nodes:
                walk(node.args)
                walk(node.kwargs)
                walk(node.meta.get("val"))
    return found


def move_program(ep, src: torch.device, dst: torch.device):
    """``ep`` moved from ``src`` to ``dst``; raises if any node or constant
    still names ``src``."""
    from torch.export.passes import move_to_device_pass

    ep = move_to_device_pass(ep, {str(src): str(dst)})
    left = {d for d in devices_named(ep) if torch.device(d) == src}
    if left:
        raise RuntimeError(f"serving program moved to {dst} still names "
                           f"{sorted(left)}")
    return ep


def load_serving(path: str, *, device=None,
                 allow_device_mismatch: bool = False) -> ServingModel:
    """Load an artifact written by ``export_serving`` onto ``device`` (None:
    the device it was exported on). A ``stablehlo`` artifact loads on any
    CPU or CUDA device (``move_program``); ``aot`` refuses any device but
    its own, and a device kind other than the one it records unless
    ``allow_device_mismatch``. A device this process lacks raises. On a
    CUDA device an ``aot`` load warms up and captures its CUDA graph here,
    and a capture that fails raises. On a CUDA device the process takes
    the eager model's arithmetic settings (``utils/env.py::
    reference_numerics``: no TF32, float32 sums in bfloat16 matmuls)."""
    meta = read_meta(path)
    recorded = torch.device(meta["device"])
    device = _load_device(device, recorded, path, meta["format"])
    if meta["format"] == "aot":
        if device != recorded:
            raise RuntimeError(
                f"aot serving artifact {path} was exported on {recorded} "
                f"and runs there only, not on {device}: export "
                "fmt='stablehlo' to load it on another device")
        here = device_record(device)
        keys = ("platform", "device_kind", "capability", "num_devices",
                "torch_version", "cuda_version")
        if any(meta[k] != here[k] for k in keys) \
                and not allow_device_mismatch:
            raise RuntimeError(
                "aot serving artifact was exported for "
                f"{meta['num_devices']}x {meta['device_kind']} "
                f"({meta['platform']}, capability {meta['capability']}, "
                f"torch {meta['torch_version']}, CUDA {meta['cuda_version']})"
                f" but this process sees {here['num_devices']}x "
                f"{here['device_kind']} ({here['platform']}, capability "
                f"{here['capability']}, torch {here['torch_version']}, CUDA "
                f"{here['cuda_version']}). Re-export, export "
                "fmt='stablehlo' (load_serving(path, device=...) loads it "
                "on any device), or pass allow_device_mismatch=True at your "
                "own risk.")
    if device.type == "cuda":
        # the eager model's arithmetic (entry.prepare_model)
        reference_numerics()
    ep = torch.export.load(path)
    if device != recorded:
        ep = move_program(ep, recorded, device)
        meta = dict(meta, device=str(device), exported_on=str(recorded))
    module = ep.module()
    if meta["format"] == "aot" and device.type == "cuda":
        return ServingModel(_GraphedProgram(module, meta, device), meta)
    return ServingModel(module, meta)
