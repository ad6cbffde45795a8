"""The reference's dry-run side of ``tests/test_torch_dryrun.py``, run in
a process of its own (``repro.launch.dryrun`` sets its 512-device XLA
flag on import, before JAX starts). Prints one JSON object: the hooks'
specs and the input specs of every arch x shape on both production
meshes, the reduced configs' ``decode_32k`` argument bytes, the
statuses of ``long_500k`` and ``lsgaussian``, and for the reduced encdec
and vlm configs of ``_torch_family_configs`` the input specs and the
``decode_32k`` cell's argument shapes and dtypes.
"""
import json

import jax

from repro.launch import dryrun as D  # noqa: I001 — first: the XLA flag
from _torch_family_configs import FAMILY_CONFIGS
from repro.configs import ARCH_IDS, get_config, get_shape
from repro.configs.base import SHAPES, ArchConfig
from repro.launch.mesh import make_production_mesh

# the family configs whose cells take more inputs than tokens
FAMILY_INPUTS = ("whisper-large-v3", "internvl2-2b")


def _spec(v):
    return list(v.spec) if hasattr(v, "spec") else v


def _structs(tree):
    """{path: [shape, dtype]} of a tree of ShapeDtypeStructs."""
    return {jax.tree_util.keystr(k): [list(v.shape), str(v.dtype)]
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _families(mesh):
    out = {}
    for name in FAMILY_INPUTS:
        cfg = ArchConfig(**FAMILY_CONFIGS[name]).reduced()
        shape = get_shape("decode_32k")
        args = D.build_cell(cfg, shape, mesh)[1]
        out[name] = {
            "inputs": {str(decode): _structs(D.input_specs(
                cfg, shape, for_decode=decode)) for decode in (False, True)},
            "params": _structs(args[0]), "tokens": _structs(args[1]),
            "cache": _structs(args[2]._asdict())}
    return out


def main():
    out = {"hooks": {}, "inputs": {}, "decode_args": {}, "status": {}}
    out["families"] = _families(make_production_mesh(multi_pod=False))
    for mp in (False, True):
        mesh = make_production_mesh(multi_pod=mp)
        for arch in ARCH_IDS:
            for s in SHAPES:
                hooks = D.make_hooks(get_config(arch), s, mesh)
                out["hooks"][f"{arch}|{s.name}|{mp}"] = {
                    k: _spec(v) for k, v in hooks.items()}
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for s in SHAPES:
            for decode in (False, True):
                out["inputs"][f"{arch}|{s.name}|{decode}"] = {
                    k: [list(v.shape), str(v.dtype)] for k, v in
                    D.input_specs(cfg, s, for_decode=decode).items()}
        r = D.run_cell(arch, "decode_32k", multi_pod=False, save=False,
                       cfg_override=cfg.reduced())
        out["decode_args"][arch] = (r["status"],
                                    r["memory"]["argument_size_in_bytes"])
    for arch, shape in [(a, "long_500k") for a in ARCH_IDS] + [
            ("lsgaussian", "train_4k"), ("lsgaussian", "long_500k")]:
        r = D.run_cell(arch, shape, multi_pod=False, save=False)
        out["status"][f"{arch}|{shape}"] = [r["status"], r["reason"]]
    print(json.dumps(out))


if __name__ == "__main__":
    main()
