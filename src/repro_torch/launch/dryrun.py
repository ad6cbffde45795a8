"""Dry-run: build and run every (arch x shape x mesh) cell of the LM
harness without the devices (the port of the reference's
``launch/dryrun.py``).

The reference lowers and compiles each cell for 512 placeholder host
devices and reads the compiled SPMD module's per-device cost and memory.
Here each cell runs once, op by op, as rank 0 of a fake process group of
256 (16 x 16) or 512 (2 x 16 x 16) ranks in which no collective moves a
byte: parameters, optimizer state, batches and caches are fake tensors
(``FakeTensorMode``: shapes and dtypes, no memory), placed as DTensors
by the sharding rules on ``launch/mesh.make_production_mesh``, and the
step is the one a user calls (``train_step.make_train_step``,
``model.forward(build_cache=True)``, ``model.decode_step``). ``LocalCost``
counts what rank 0 executes on its shards, which is what one device runs
(an op replicated over an axis runs on every rank of it):

  - ``flops``: ``torch.utils.flop_counter``'s formulas (the products) of
    every op on local tensors; the DTensor-level op and the fake runs
    DTensor makes to propagate shapes are not counted;
  - ``bytes_accessed``: each such op's inputs read and outputs written,
    before any fusion (views move nothing), as XLA's pre-fusion count;
  - ``collective_bytes`` / ``collective_counts``: the result bytes of each
    collective, by the reference's five kinds;
  - ``memory``: the arguments' local bytes, the outputs', the outputs
    that are arguments updated in place (``alias``), and the peak of
    local bytes allocated during the step and alive at once (``temp``).
    A host scalar (the cache index, the optimizer's step, the lr) counts
    as the 4-byte scalar the reference passes.

Artifacts go to ``build/dryrun/`` (``torch_dryrun_<arch>_<shape>_<mesh>
.json``), never the reference's ``experiments/artifacts``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b \
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun [--single-pod] \
      [--multi-pod] [--device cpu]

The mesh's device type is "cuda" unless ``--device cpu`` (or the
``device_type`` argument) asks for the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
import weakref
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ARCH_IDS, get_config, get_shape
from repro_torch.configs.base import SHAPES, shape_applicable
from repro_torch.distributed import sharding as S
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as M
from repro_torch.models import sharding_hooks as hooks
from repro_torch.train import train_step as TS
from repro_torch.train.optimizer import OptimizerConfig

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "build", "dryrun")

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
# Op name fragments of the c10d and functional-collective ops, by kind.
_KIND_OF = (("all_gather", "all-gather"), ("allgather", "all-gather"),
            ("reduce_scatter", "reduce-scatter"),
            ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
            ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
            ("send", "collective-permute"), ("recv", "collective-permute"))
_C10D = ("c10d", "_c10d_functional")


def make_hooks(cfg, shape, mesh,
               overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Activation constraints + execution flags for one cell, as the
    reference's: each constraint a ``sharding.Sharding`` on ``mesh``."""
    def sh(*spec):
        return S.Sharding(mesh, S.to_placements(S.P(*spec), mesh))

    h: Dict[str, Any] = {}
    baxes = S.batch_axes(mesh)
    model_size = S.axis_sizes(mesh)["model"]
    if shape.kind in ("train", "prefill") and cfg.family != "renderer":
        if shape.seq_len % model_size == 0:
            if cfg.family == "moe" and cfg.d_model % model_size == 0:
                # MoE residuals shard d (not seq): the row-local dispatch
                # would otherwise re-gather seq every layer.
                h["residual"] = sh(baxes, None, "model")
            else:
                h["residual"] = sh(baxes, "model", None)
            h["attn_scores_gqa"] = sh(baxes, None, None, "model", None)
            h["attn_scores_mla"] = sh(baxes, None, "model", None)
    h["attn_impl"] = "sdpa" if shape.kind == "train" else \
        ("flash" if shape.kind == "prefill" else "auto")
    # Expert buffers (B, E, C, d): rows over the data axes, experts over
    # "model". On for MoE; {"moe_ep": False} turns it off.
    moe_ep = cfg.family == "moe" and cfg.num_experts % model_size == 0
    if overrides:
        ov = dict(overrides)            # never mutate the caller's dict
        moe_ep = ov.pop("moe_ep", moe_ep)
        h.update(ov)
    if moe_ep:
        h["moe_buf"] = sh(baxes, "model", None, None)
        h["moe_buf_decode"] = sh("model", None, None)
    return h


def input_specs(cfg, shape, *, for_decode: bool = False
                ) -> Dict[str, torch.Tensor]:
    """Shape and dtype stand-ins (tensors on the "meta" device) for every
    model input of the cell: tokens and labels, encdec's encoder frames
    (B, encoder_seq, D) and vlm's vision embeddings (B, V, D), both
    bfloat16 as in the reference (a decode cell's have no labels; the
    step itself takes the tokens only)."""
    b = shape.global_batch
    s = 1 if for_decode else shape.seq_len
    d = {"tokens": torch.empty((b, s), dtype=torch.int32, device="meta")}
    if not for_decode:
        d["labels"] = torch.empty((b, s), dtype=torch.int32, device="meta")
    if cfg.family == "encdec":
        d["frames"] = torch.empty((b, cfg.encoder_seq, cfg.d_model),
                                  dtype=torch.bfloat16, device="meta")
    if cfg.family == "vlm":
        d["vision"] = torch.empty((b, cfg.num_vision_tokens, cfg.d_model),
                                  dtype=torch.bfloat16, device="meta")
    return d


def decode_cache(cfg, shape, device):
    """The decode cell's cache before placement: ``init_cache`` at the
    cell's batch and length, with a bfloat16 stand-in for encdec's
    encoder output (B, encoder_seq, D), as the reference's cell has."""
    cache = M.init_cache(cfg, shape.global_batch, shape.seq_len,
                         device=device)
    if cfg.family == "encdec":
        cache = cache._replace(enc_out=torch.zeros(
            (shape.global_batch, cfg.encoder_seq, cfg.d_model),
            dtype=torch.bfloat16, device=device))
    return cache


def build_cell(cfg, shape, mesh):
    """(fn, args): the cell's step and its arguments on ``mesh``, built
    from whatever tensors the current mode makes (call it under
    ``FakeTensorMode``). The arguments are placed by ``param_shardings``,
    ``batch_shardings`` and ``cache_shardings``; ``fn`` places its
    outputs as the reference's out_shardings do (prefill: logits batch x
    vocab over "model", the cache by ``cache_shardings``; decode: logits
    by batch). Train updates the state in place and decode the cache,
    as the reference donates them."""
    dev = mesh.device_type

    def batch(for_decode=False):
        specs = input_specs(cfg, shape, for_decode=for_decode)
        if shape.kind == "prefill":
            specs.pop("labels")
        b = {k: torch.zeros(v.shape, dtype=v.dtype, device=dev)
             for k, v in specs.items()}
        return S.distribute(b, S.batch_shardings(b, mesh))

    if shape.kind == "train":
        state = TS.init_train_state(cfg, device=dev, mesh=mesh)
        return TS.make_train_step(cfg, OptimizerConfig(), mesh), \
            (state, batch())

    params = M.init_params(cfg, device=dev)
    params = S.distribute(params, S.param_shardings(params, mesh))
    if shape.kind == "prefill":
        vocab = "model" if cfg.vocab_size % S.axis_sizes(mesh)["model"] == 0 \
            else None
        logits_sh = S.Sharding(mesh, S.to_placements(
            S.P(S.batch_axes(mesh), None, vocab), mesh))

        def prefill(p, bt):
            with torch.no_grad():
                logits, _, cache = M.forward(p, bt, cfg, build_cache=True)
            return (S.place(logits, logits_sh),
                    S.distribute(cache, S.cache_shardings(cache, mesh)))
        return prefill, (params, batch())

    cache = decode_cache(cfg, shape, dev)
    cache = S.distribute(cache, S.cache_shardings(cache, mesh))

    def decode(p, toks, c):
        with torch.no_grad():
            logits, c = M.decode_step(p, toks, c, cfg)
        return S.place(logits, S.batch_shardings({"x": logits}, mesh)["x"]), c
    return decode, (params, batch(for_decode=True)["tokens"], cache)


def _kind(func) -> Optional[str]:
    namespace, _, name = func.name().partition("::")
    if namespace not in _C10D:
        return None
    return next((k for frag, k in _KIND_OF if frag in name), None)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _local(leaf):
    return leaf.to_local() if isinstance(leaf, DTensor) else leaf


def _leaves(tree):
    """The leaves of an argument or output tree (tensors, host scalars)."""
    return [leaf for _, leaf in S._leaves(tree) if leaf is not None]


def _bytes(leaf) -> int:
    leaf = _local(leaf)
    if isinstance(leaf, torch.Tensor):
        return _nbytes(leaf)
    return 4 if isinstance(leaf, (int, float)) else 0


class LocalCost(TorchDispatchMode):
    """Counts the ops that run on plain (local) tensors: what this rank's
    device executes, under ``fake_mode``. An op on DTensors is handed on
    (``NotImplemented``) to DTensor, whose local ops and collectives then
    come back here. The shape propagation DTensor runs for itself is not
    counted (``_counted``)."""

    def __init__(self, fake_mode):
        super().__init__()
        self.fake_mode = fake_mode
        self.flops = 0
        self.bytes = 0
        self.collective_bytes = dict.fromkeys(_COLLECTIVES, 0.0)
        self.collective_counts = dict.fromkeys(_COLLECTIVES, 0)
        self.live = 0
        self.peak = 0
        self._storages: Dict[int, int] = {}

    def known(self, tree) -> None:
        """Take the storages of ``tree``'s tensors as existing before the
        step (arguments), so that they and their views are not counted
        as allocated."""
        for leaf in _leaves(tree):
            leaf = _local(leaf)
            if isinstance(leaf, torch.Tensor):
                self._track(leaf, 0)

    def _track(self, t: torch.Tensor, size: Optional[int] = None) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return
        size = st.nbytes() if size is None else size
        self._storages[key] = size
        self.live += size
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._storages.pop(key, 0)

    def _counted(self, tensors) -> bool:
        """False for DTensor's own shape propagation: it runs the op on
        global-shaped fake tensors, in a FakeTensorMode of its own or
        inside ``fake_mode`` entered once more."""
        from torch._subclasses.fake_tensor import FakeTensor
        if len(self.fake_mode.enter_stack) > 1:
            return False
        return all(t.fake_mode is self.fake_mode for t in tensors
                   if isinstance(t, FakeTensor))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if not self._counted(ins + outs):
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if not func.is_view:
            self.bytes += sum(_nbytes(t) for t in ins + outs)
        kind = _kind(func)
        if kind is not None:
            self.collective_bytes[kind] += sum(_nbytes(t) for t in outs)
            self.collective_counts[kind] += 1
        for t in outs:
            self._track(t)
        return out


def count_cell(cfg, shape, mesh,
               hook_overrides: Optional[Dict[str, Any]] = None
               ) -> Dict[str, Any]:
    """Build ``shape``'s cell of ``cfg`` on ``mesh`` from fake tensors,
    run it once under ``make_hooks``' hooks and return this rank's
    counts (the keys ``run_cell`` records) and the seconds spent placing
    the arguments (``build_s``) and running the step (``run_s``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    fake = FakeTensorMode()
    with fake:
        t0 = time.perf_counter()
        fn, args = build_cell(cfg, shape, mesh)
        build_s = time.perf_counter() - t0
        cost = LocalCost(fake)
        cost.known(args)
        hooks.set_hooks(make_hooks(cfg, shape, mesh, hook_overrides))
        try:
            t0 = time.perf_counter()
            with TS.on_mesh(mesh), cost:
                out = fn(*args)
            run_s = time.perf_counter() - t0
        finally:
            hooks.set_hooks({})
        arg_keys = {_local(x).untyped_storage()._cdata
                    for x in _leaves(args)
                    if isinstance(_local(x), torch.Tensor)}
        outs = _leaves(out)
        alias = sum(_bytes(x) for x in outs
                    if isinstance(_local(x), torch.Tensor)
                    and _local(x).untyped_storage()._cdata in arg_keys)
        memory = {"temp_size_in_bytes": cost.peak,
                  "argument_size_in_bytes": sum(map(_bytes, _leaves(args))),
                  "output_size_in_bytes": sum(map(_bytes, outs)),
                  "alias_size_in_bytes": alias}
    return {"build_s": round(build_s, 1), "run_s": round(run_s, 1),
            "flops": float(cost.flops), "bytes_accessed": float(cost.bytes),
            "collective_bytes": dict(cost.collective_bytes),
            "collective_counts": dict(cost.collective_counts),
            "memory": memory}


def fake_group(world: int) -> None:
    """Make the default process group a fake one of ``world`` ranks, this
    process rank 0 (a fake group of another size is replaced; a real one
    is refused)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("a real process group is running; the dry-run "
                               "needs its own fake one")
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             save: bool = True,
             hook_overrides: Optional[Dict[str, Any]] = None,
             cfg_override=None, tag: str = "",
             device_type: str = "cuda") -> Dict[str, Any]:
    cfg = cfg_override if cfg_override is not None else get_config(arch)
    shape = get_shape(shape_name)
    ok, why = shape_applicable(cfg, shape)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    result: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "family": cfg.family, "status": "skipped", "reason": why,
    }
    if not ok:
        _save(result, save)
        return result

    if tag:
        result["tag"] = tag
    try:
        fake_group(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod,
                                    device_type=device_type)
        counts = count_cell(cfg, shape, mesh, hook_overrides)
        result.update({
            "status": "ok", **counts,
            "params": cfg.param_count(),
            "active_params": cfg.active_param_count(),
            "tokens": shape.tokens if shape.kind != "decode"
            else shape.global_batch,
            "kind": shape.kind,
        })
    except Exception as e:  # noqa: BLE001 — dry-run reports, caller decides
        result.update({"status": "error", "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-3000:]})
    _save(result, save)
    return result


def _save(result: Dict[str, Any], save: bool) -> None:
    if not save:
        return
    os.makedirs(ARTIFACT_DIR, exist_ok=True)
    name = (f"torch_dryrun_{result['arch']}_{result['shape']}_"
            f"{result['mesh']}.json")
    with open(os.path.join(ARTIFACT_DIR, name), "w") as f:
        json.dump(result, f, indent=1)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS + ("all",), default="all")
    ap.add_argument("--shape", default="all",
                    choices=[s.name for s in SHAPES] + ["all"])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the mesh's device type")
    args = ap.parse_args()

    archs = ARCH_IDS if args.arch == "all" else (args.arch,)
    shapes = [s.name for s in SHAPES] if args.shape == "all" else (args.shape,)
    meshes = []
    if args.single_pod or not args.multi_pod:
        meshes.append(False)
    if args.multi_pod:
        meshes.append(True)

    n_fail = 0
    for arch in archs:
        for shape_name in shapes:
            for mp in meshes:
                r = run_cell(arch, shape_name, multi_pod=mp,
                             device_type=args.device)
                tag = r["status"].upper()
                extra = r.get("error", r.get("reason", ""))
                print(f"[{tag:7s}] {arch:26s} {shape_name:12s} "
                      f"{r['mesh']:10s} run={r.get('run_s', '-')}s {extra}",
                      flush=True)
                if r["status"] == "error":
                    n_fail += 1
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
