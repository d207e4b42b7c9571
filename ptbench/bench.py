"""The harness: finds a cell's pieces by name and runs it.

Every piece is a file found by the name `BENCHMARK.json` gives it, so a
cell, a configuration, a traffic mix or a metric is added as files and
entries alone:

  configs/<config>.json   the scene (materials, spheres, ellipsoids,
                          implicits, sky, mesh), the RenderConfig fields,
                          the source, what was cut (`reduced`) and assumed
  configs/<config>.py     (optional) code that makes the scene's data
                          (`sky_image`, `mesh`, `camera`) and the
                          reference's own scene query (`reference_query`)
  traffic/<mix>.json      the parameters of the one session generator
                          (drive.py)
  limits/<workload>.json  each number `correct` compares, with its limit
  metrics/<metric>.py     one reader a metric, `read(record)`: a number,
                          or None where the run has nothing to read

The program under test is the port, `pathtracer0_tpu_torch`, driven through
its public API; the reference (reference/) imports nothing of it.
"""
from __future__ import annotations

import copy
import dataclasses
import importlib.util
import json
import os
from pathlib import Path

import numpy as np

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
# RenderConfig fields a configuration's "render" may set, with the
# program's defaults the reference reads where it sets none
RENDER_DEFAULTS = {"width": 800, "height": 600, "cam_size": 1.5,
                   "focal_length": 1.0, "samples_per_frame": 8,
                   "max_bounces": 6, "blur": 0.001, "focal_distance": 1.0,
                   "auto_focus": False, "refraction_stack_depth": 10,
                   "stream_threshold": 65536}


def merge(base, over):
    """`base` with the keys of `over` put in, dicts merged key by key."""
    out = copy.deepcopy(base)
    for k, v in (over or {}).items():
        out[k] = (merge(out[k], v) if isinstance(v, dict)
                  and isinstance(out.get(k), dict) else copy.deepcopy(v))
    return out


def benchmark():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One workload of BENCHMARK.json with its pieces loaded."""

    name: str
    config: dict
    config_module: object
    mix: dict
    limits: dict
    end_to_end: list
    per_layer: list


def _reports(metric, workload, e2e_names):
    if "workloads" in metric:
        return workload in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def cell(workload: str, overrides=None) -> Cell:
    """The cell `workload` of BENCHMARK.json; `overrides` = {"config":
    ..., "mix": ...} is merged into its configuration and traffic (the
    tests shrink a cell through it)."""
    bench = benchmark()
    pkg = ROOT / "ptbench"
    w = next((w for w in bench["workloads"] if w["name"] == workload),
             None)
    if w is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    overrides = overrides or {}
    with open(pkg / "configs" / f"{w['config']}.json") as f:
        config = merge(json.load(f), overrides.get("config"))
    code = pkg / "configs" / f"{w['config']}.py"
    module = _module(code, f"ptbench_config_{w['config']}") \
        if code.exists() else None
    with open(pkg / "traffic" / f"{w['traffic']}.json") as f:
        mix = merge(json.load(f), overrides.get("mix"))
    with open(pkg / "limits" / f"{workload}.json") as f:
        limits = json.load(f)
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _reports(m, workload, names)]
    return Cell(workload, config, module, mix, limits, e2e, layer)


def metric_reader(name: str):
    return _module(ROOT / "ptbench" / "metrics" / f"{name}.py",
                   f"ptbench_metric_{name.replace('.', '_')}").read


def render_fields(config: dict) -> dict:
    return {**RENDER_DEFAULTS, **config["render"]}


def camera(config: dict, module):
    if "camera" in config:
        return (tuple(config["camera"]["pos"]),
                tuple(config["camera"]["rot"]))
    return module.camera(config["mesh"])


def sky_image(config: dict, module):
    sky = config["sky"]
    if "constant" in sky:
        return np.full((1, 1, 3), 0.0, np.float32) + np.asarray(
            sky["constant"], np.float32)
    return module.sky_image(sky["image"])


def mesh(config: dict, module):
    """(verts, faces, extra) of the configuration's mesh, or None."""
    if "mesh" not in config:
        return None
    return module.mesh(config["mesh"])


def build_program_scene(config: dict, module, device):
    """The scene built through the port's public API, packed on
    `device`: (PackedScene, SceneInfo, RenderConfig). Spheres, then
    ellipsoids, each in list order: the order of the port's table of
    ellipsoids, which the reference's closest hit keeps."""
    from pathtracer0_tpu_torch import RenderConfig, Scene

    sc = Scene()
    sky = config["sky"]
    if "constant" in sky:
        sc.set_constant_sky(tuple(sky["constant"]))
    else:
        sc.set_sky(sky_image(config, module), "sky")
    for m in config["materials"]:
        sc.add_material(m["name"])
        for k, v in m["props"].items():
            sc.set_last_mtl(k, v)
    for s in config.get("spheres", []):
        sc.add_sphere(tuple(s["center"]), s["radius"], m=s["material"])
    for e in config.get("ellipsoids", []):
        sc.add_ellipsoid(tuple(e["center"]), tuple(e["stretch"]),
                         tuple(e["rot"]), e["radius"], m=e["material"])
    for k in config.get("implicits", []):
        sc.add_implicit(k["fn"], tuple(k["shift"]), tuple(k["scale"]),
                        tuple(k["rot"]), k["material"])
    got = mesh(config, module)
    if got is not None:
        verts, faces, _ = got
        sc.add_mesh_indexed(verts, faces, config["mesh"]["material"])
    rc = RenderConfig(**render_fields(config))
    scene, info = sc.build(config=rc, device=device)
    return scene, info, rc


def build_reference_scene(config: dict, module, device):
    """The reference's own tables of the same configuration."""
    import torch

    from .reference import tracer

    mats = tracer.material_tables(config["materials"], device)
    sph = torch.tensor(np.asarray(
        [list(s["center"]) + [s["radius"], s["material"]]
         for s in config.get("spheres", [])], np.float32).reshape(-1, 5),
        device=device)
    sky = torch.tensor(sky_image(config, module), device=device)
    got = mesh(config, module)
    tri_n = torch.zeros((0, 3), dtype=torch.float32, device=device)
    tri_mat = torch.zeros(0, dtype=torch.int64, device=device)
    query = None
    if got is not None:
        verts, faces, extra = got
        v1, v2, v3 = (verts[faces[:, k]] for k in range(3))
        tri_n = torch.tensor(tracer.flat_normals(v1, v2, v3), device=device)
        tri_mat = torch.full((faces.shape[0],), config["mesh"]["material"],
                             dtype=torch.int64, device=device)
        rows = tracer.triangle_rows(v1, v2, v3, device)
        query = (module.reference_query(config["mesh"], verts, faces, extra,
                                        rows)
                 if hasattr(module, "reference_query")
                 else tracer.BruteQuery(*rows))
    ell = config.get("ellipsoids", [])
    imp = config.get("implicits", [])
    return tracer.RefScene(
        mats=mats, sph=sph, tri_n=tri_n, tri_mat=tri_mat, sky=sky,
        query=query,
        ell=tracer.framed_table(
            [list(e["center"]) + list(e["stretch"])
             + [e["radius"], e["material"]] for e in ell],
            [e["rot"] for e in ell], 8, device),
        imp=tracer.framed_table(
            [list(k["shift"]) + list(k["scale"]) + [k["material"]]
             for k in imp], [k["rot"] for k in imp], 7, device,
            fn=[k["fn"] for k in imp]))


def check_config(config: dict):
    """Refuse what the reference does not render: modes other than path
    mode, autofocus, texture maps, implicit surfaces other than 1..10."""
    r = render_fields(config)
    if not r.get("raytracing", True) or r.get("debug") or r.get(
            "legacy_pathtrace"):
        raise ValueError("the reference renders path mode only")
    if r["auto_focus"]:
        raise ValueError("the reference takes the focal distance as given: "
                         "set auto_focus false")
    bad = {k for m in config["materials"] for k in m["props"]
           if k.startswith("map_")}
    if bad:
        raise ValueError(f"the reference has no texture maps: {bad}")
    fns = [k["fn"] for k in config.get("implicits", [])
           if k["fn"] not in range(1, 11)]
    if fns:
        raise ValueError(f"implicit surfaces are functions 1..10, not {fns}")


def tmp_dir():
    """The run's scratch directory: under $TMPDIR where it is set, else
    inside the checkout."""
    base = os.environ.get("TMPDIR") or str(ROOT / "ptbench" / "_tmp")
    os.makedirs(base, exist_ok=True)
    return base
