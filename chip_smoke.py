#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (pathtracer0_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--profile] [--parent LABEL=DIR ...]

Phases, one JSON line each; any failed check raises and the script exits
non-zero:

  1. environment   card name and power limit; the six CUDA sources (one
                   nvcc each) and the six host libraries (g++: the LBVH
                   build, the OBJ tokenizer and, for the CPU tests, the
                   forest kernels' triangle test, the block kernel's
                   triangle loop, the group tests' candidate test and
                   group loop, the bounce kernel's per-ray body) are built
                   together; each kernel instantiation's registers and
                   spills, and its local-memory, call and load
                   instructions by width in the SASS
  2. kernels       each kernel against its plain PyTorch version on the
                   card, with kernel, plain and bound times (the render
                   kernels' `ms` is the time of their launches alone, 20
                   back to back between CUDA events, `wrapper_ms` the
                   CUDA-event time of calls of their Python wrappers):
                   frame_kernel for configs 1 (Whitted), 2, 3, 4 and 6 at
                   320x240, 2 spp, 6 bounces, and at 800x600: there
                   checked at 2 spp, then timed and checked again (looser,
                   TIMED_*) at the main path's spp;
                   brute_kernel (a 12x12 OBJ grid) and traverse_kernel
                   (the 64,800-triangle terrain) on the 800x600 primary
                   rays of the scene's camera and as many random rays, one
                   in seven switched off; brute_kernel also on the grid's
                   480,000 primary rays alone, the batch the main path
                   gives it; traverse_kernel also on the walks of one
                   sample of the cell terrain181.progressive (the terrain
                   at one triangle a leaf, its camera rays and its third
                   bounce), all six outputs bit-equal;
                   block_kernel on one sample's rays at 800x600 of config 6
                   and of the OBJ grid, with the share of a warp's lanes a
                   bounce step keeps busy and of its cycles each part of a
                   scene query takes (`block_phases`: the check-only LANES
                   and PHASES instantiations, outputs equal to the
                   kernel's); and its two triangle loops, plain and
                   staged with the early exit, in turns on grids of 4 to
                   144 triangles and on config 6 (`block_stage_min`);
                   streamed_kernel on the 999,698-triangle terrain
                   (scenes.terrain(708)): the 480,000 primary rays of its
                   camera and 960,000 rays (primary + random, one in seven
                   switched off), each as given and in the order the
                   route sorts them (the sorted primary rays are the batch
                   the main path gives it), with the sort's own cost and
                   the whole query both ways in turns (the PyTorch sort
                   around the kernel, and the route's: sort_key_kernel,
                   the argsort, the ordered walk); where
                   a warp's cycles go on each (`streamed_phases`: the
                   check-only PHASES instantiation, with the lanes that
                   test a group together and the distinct groups among
                   them); and against traverse_kernel on the n = 181
                   terrain built both ways (stream_threshold=0 against the
                   SAH forest);
                   the group-test kernels (vpu_kernel, mxu_kernel and
                   mxu_big_kernel at both precisions, mxu_big_kernel with
                   mm_only, mxu_split3_kernel) at the diagnostic's own shape
                   (32 groups, 16,384 synthetic rays) and at the card's
                   width: the 1M terrain's 480,000 primary rays against the
                   32 groups of the treelet most of them hit; the products
                   themselves against float32 ones, B against C, and each
                   form against A (recorded); prefilter_kernel (row E) at
                   the same three shapes, with the hits of A it lost and
                   its gate counts; the `ms` of every group-test kernel
                   is that of its launches alone, as the render kernels'
                   (CUDA events around its wrapper beside it); where
                   mxu_kernel's warps' cycles go (`group_phases`: its
                   check-only PHASES instantiation, outputs equal to the
                   kernel's) at the card's width and on the aimed rays,
                   both precisions, and prefilter_kernel's (its own PHASES
                   instantiation) on all three shapes; `group_nan`: rows
                   B, C, D on the aimed rays' table with NaN in one
                   coefficient of the 20 slots that win most often, none
                   of which may then win (a NaN fails the sign test, as in
                   the JAX reference);
                   the refill schedule of frame_kernel for configs 2, 3, 4
                   and 6 at 800x600: against the plain version at 2 spp, and
                   against the default schedule at the main path's 16 spp
                   (bit-equal), both timed in turns, and the share of a
                   warp's lanes a bounce step keeps busy in either schedule
                   (check-only counting instantiations);
                   mm_probe_kernel, every form and precision, at the
                   probe's N = 1,024 and at 480,000: device ms of one
                   launch of one product and of PROBE_CHECK_REPS, and
                   their difference per product;
                   `phases`: the share of a warp's cycles that each part of
                   a scene query takes in frame_kernel (the check-only
                   PHASES instantiations), configs 1, 2, 3, 4, 6 at 800x600 and
                   the main path's spp, both schedules
  3. main paths    every launch counter is zeroed just before each and
                   read just after.
                   Frame path: Renderer at 800x600 with autofocus, config
                   1 1 spp Whitted, configs 2, 3, 4 and 6 16 spp, 6
                   bounces, one warm-up frame and 2 timed frames each.
                   Per-bounce route: the terrain (bench.py's height
                   function at n = 181, a metal and a glass sphere on it)
                   through Renderer at 800x600, 8 spp, 6 bounces, one
                   warm-up and 2 timed frames in path mode and one Whitted
                   frame (traverse_kernel); a 12x12 grid loaded from an OBJ
                   file, at 800x600, 8 spp, one warm-up and 2 timed frames,
                   through Renderer with fused="off" (brute_kernel) and
                   through render_rays with fused="on" (block_kernel).
                   Streamed route: the 999,698-triangle terrain through
                   Renderer at 800x600, 2 spp, 3 bounces, no autofocus, one
                   warm-up and 2 timed frames in path mode and one Whitted
                   frame (streamed_kernel, one launch per sample and
                   bounce, no other kernel).
                   Diagnostic: tools.diag_mxu.main at its defaults (32
                   groups, 64 passes, 16,384 rays) and at the card's width
                   (480,000 rays, 4 passes): rows A, B, C, C mm_only, D, E.
                   Refill: configs 2, 3, 4, 6 through Renderer at 800x600x16
                   with PT0_FUSED_REFILL=1, in turns with a Renderer of the
                   default schedule on the same frames (default, refill,
                   refill, default; a warm-up and a timed frame a turn).
                   Probe: tools.diag_mxu_mm.main at its defaults (N =
                   1,024, 512 reps) and at N = 480,000 (16 reps)
  4. routes        the terrain on the card through the kernels against the
                   same bounce loop over their plain versions at 320x240x2,
                   built over the SAH forest and streamed, and the two
                   against each other (RMSE < 0.05);
                   the OBJ grid at 160x120x4: block path, per-bounce route
                   and frame kernel against each other (RMSE < 0.05)
  5. goldens       configs 1, 2, 3, 4, 6 at 160x120x4, seed 1234, against
                   tests/goldens/config{n}.png (RMSE < 0.05)
  6. session       the renderer as a user drives it (`session`): the
                   config-5 hero at 1920x1080x8 through Renderer.render
                   (Mrays/s, samples/s, seconds to 4096 spp); a checkpoint
                   resumed in a fresh Renderer, bit-equal after one more
                   step; `pick` on 3 x 3 pixels against the CPU's in config
                   3, the OBJ grid and the 1M terrain; the scripted driver
                   session on config 3 at 800x600x8 (ms of a preview and a
                   full tick); the CLI as a subprocess
  7. modes         the render modes off the frame path at 800x600
                   (`modes`): legacy shading (S = 4) and the legacy
                   pathTrace (S = 2) on the terrain and the OBJ grid with
                   an emissive sphere as their light, fold_spp on the
                   terrain at 8 spp, the debug heatmap on a two-object
                   forest (the terrain and the OBJ grid) and on the 1M
                   terrain: frame ms, launches per frame by kernel (of the
                   legacy modes also what one query per grid point would
                   launch), the card's busy share under torch.profiler;
                   each against the CPU route at 160x120 (and the legacy
                   modes at S = 0), the heatmap's counters against the
                   plain walks
  8. obj           the native OBJ parser (`obj_phase`): the 1M terrain
                   written as a 50 MB OBJ, loaded through add_object (the
                   native parser, by size) and built streamed: its tables
                   against the add_mesh_indexed build field by field, one
                   Whitted and one path frame of each at 800x600
                   (streamed_kernel); the n = 181 terrain's OBJ through
                   both parsers, their tables equal, both parse times
  9. dist          rendering over several devices and processes
                   (`dist_phase`): the config-5 hero at 1920x1080x8 and the
                   1M terrain at 800x600x2 tiled over [cuda:0] * 4 against
                   one untiled render_rays (block_kernel,
                   streamed_kernel); the sample split of config 2 over
                   [cuda:0] * 2 against the mean of its two seeds, and its
                   golden; DistributedRenderer on the hero (Mrays/s beside
                   phase `session`'s, checkpoint resume, camera reset);
                   two processes on the card over gloo, the assembled
                   image against one process's; a mesh of two cards where
                   there are two
 10. tools         the port's run tools at their full defaults, each
                   through its own entry point (`tools_phase`):
                   tools.profile on configs 1, 2, 3, 4, 6 (its five rows:
                   full frame, 1 bounce, 1 spp, fused=off, fused=on, with
                   launches a frame; --trace on config 3: busy share and
                   kernels); tools.diag_streamed on the 1M terrain (its
                   four populations of 262,144 rays, each held against
                   streamed_reference with the kernel's device ms and
                   bound); tools.diag_scale_frame (six settings, queries
                   rising with bounces); tools.diag_build4m on the
                   4,004,450-triangle terrain with the peak allocated
                   memory of its build and of one 800x600, 2 spp, 3-bounce
                   frame; tools.run_hero_full to 4,096 spp (512 frames,
                   checkpoints every 64, a second accumulation), its time
                   beside phase `session`'s estimate
 11. bounce        bounce_kernel, one launch a bounce of the per-bounce
                   route (`bounce_phase`): against bounce_step_plain on
                   one sample's 800x600 rays of the terrain, the OBJ grid,
                   the 1M terrain and configs 4 and 6, bounce after bounce
                   from the same state and walk, at the kernel-parity
                   limits; the Whitted form on the same scenes and, with
                   the thickness probe, the OBJ grid with a subsurface
                   material; the kernel's ms (20 launches on as many
                   copies of the state), the plain version's and the
                   bound at each bounce; with --parent, each form of
                   every tree's bounce_kernel in turns with this one on
                   the same state and walk (tools/bounce_turns.turns),
                   bit-equal; the camera form (one launch a sample of
                   render_rays) against camera_step_plain on each cell's
                   480,000 rays at blur 0 and 0.001, its ms and bound;
                   refraction stacks of 17 and 32 on the terrain and
                   config 2 (which then leaves the frame path): the path
                   form against its plain version and a frame through
                   Renderer; frames of each cell through Renderer (this
                   checkout's with camera.dof_ray made to raise, and each
                   --parent's): wall and CUDA ms, launches a frame (one
                   camera form a sample), the card's busy share and
                   device operations a frame and a bounce under
                   torch.profiler

With `--profile` it also traces one frame of the n = 181 terrain and one of
the 999,698-triangle terrain with torch.profiler and records the card's
busy time, its kernel count and the kernels that took most of it (phase
`profile`).

With `--parent LABEL=DIR` (repeatable) it also loads the package of another
checkout, DIR/pathtracer0_tpu_torch (the parent commit unpacked with `git
archive`, say), builds its forest and streamed kernels (phase `bounce`
renders the per-bounce route's frames through its Renderer too) and those
of its frame, block and group-test kernels whose sources differ from this
one's, and holds each whose sources differ (the forest and streamed
kernels also where kernels/wavefront.py differs)
against this checkout's (phase `parent_vs_change`), whatever the others
do: frame_kernel in configs 1, 2, 3, 4, 6 at 800x600 and the main path's spp
in both schedules, traverse_kernel on the terrain's 960,000 rays and on
the walks of one sample of the cell terrain181.progressive (its camera
rays' and its third bounce's; bits equal on every ray, and the dependent
fetch rounds a live ray of both node layouts, worked out from the
counters),
brute_kernel on the OBJ grid's 480,000 primary and 960,000 mixed rays,
block_kernel on the OBJ grid's rays, streamed_kernel on the 1M terrain's
four populations, the group-test kernels (rows A-E, both precisions,
mm_only) on the diagnostic's three populations at the group-test parity
limits and to every bit (streamed_kernel to every bit too, mxu_kernel's
products to 2^-20 of the sum of magnitudes), and mm_probe_kernel in every
case of the probe at N = 1,024 and 480,000 and PROBE_CHECK_REPS reps, to
every bit (and a product's time), the same inputs through
both, their outputs compared and their device times taken in turns
(parent, change, change, parent, parent, change; the median of each
side), with each
build's registers, spills and local-memory instructions and, where the
other package has it, its PHASES shares.

Then the `kernels` summary line and, last, the `ok` line. Without a CUDA
device it prints no result and exits 2. The full record goes to
chiprun_out/chip_smoke.json.
"""
import dataclasses
import inspect
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
W_CMP, H_CMP, SPP_CMP, BOUNCES = 320, 240, 2, 6
MAIN = {1: (1, False), 2: (16, True), 3: (16, True), 4: (16, True),
        6: (16, True)}
TERRAIN_N, TERRAIN_SPP, TERRAIN_LEAF = 181, 8, 4
# the streamed route's cell: the scale benchmark's terrain and settings
BIG_N, BIG_SPP, BIG_BOUNCES = 708, 2, 3
GOLDEN = (160, 120, 4, 1234)
# grids of side x side triangles on which block_kernel's two triangle loops
# are timed (phase `block_stage_min`)
STAGE_GRID_SIDES = (2, 3, 4, 5, 6, 8, 12)
# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s; flop/s of
# float32 outside the tensor cores and of TF32 and bf16 on them. The data
# sheet's flop rates are 132 SMs' at one clock each: float32 256 a clock and
# SM at 1,980 MHz, TF32 2,048 and bf16 4,096 at 1,830 MHz. The card may run
# its SMs at up to its clocks.max.sm, so `set_peaks` takes for each type
# the larger of the data sheet's rate and the card's SMs at that clock,
# read in the same run: a bound from a rate below the card's would be
# longer than the least time the card can take.
PEAK_BYTES = 3.35e12
DATA_SHEET = {"f32": 67e12, "tf32": 495e12, "bf16": 989e12}
PER_SM_CLOCK = {"f32": 256, "tf32": 2048, "bf16": 4096}
PEAK = dict(DATA_SHEET)
# Float operations that every scene query of the frame kernel surely does
# (csrc/pathtrace.cuh closest_hit), counted from the source: the nudge
# and hit test, each triangle test up to its first compare, each
# ellipsoid test up to its first compare, each implicit's transform to
# its frame and bounding-sphere test, and two 3x3 rotations for each
# rotated ellipsoid or implicit. Work that depends on the data (the
# implicit march, bisection and gradient, shading, the sky) is not
# counted, so the bound is a floor.
OPS_QUERY, OPS_TRI, OPS_ELL, OPS_IMP, OPS_ROT = 7, 47, 47, 41, 30
# The forest kernels (csrc/forest_kernel.cu), counted from the source: a
# box test is 6 subtractions, 6 products and 11 min/max; of the dividing
# triangle test only what every test surely needs, up to the first
# compare that can reject it (|det| >= 1e-10): the cross product d x e2
# (9) and the determinant (5). The rest of the test (46 operations in
# all) depends on the data, so the bound is a floor.
OPS_BOX, OPS_TRI_DIV = 23, 14
# The streamed kernel (csrc/streamed_kernel.cu): the same box test; of the
# division-free triangle test d x e2 (9), the determinant (5) and its sign
# fold (1), up to the first compare that can reject (|det| >= 1e-10).
OPS_TRI_FREE = 15
# The group-test kernels (csrc/mxu_group_kernel.cu). Tensor-core peaks
# (PEAK): TF32 for "highest" (three passes), bf16 for "default" (one) and
# the bf16 split (three). What the
# closest-hit function needs of a pass, per ray and group: 5 quantities of
# 56 triangles over the 10 features that are ever non-zero, 2 x 10 x 280
# operations. The kernels multiply the padded table, 2 x 16 x 320 (8 pad
# candidates a quantity, 6 zero features): that count bounds only
# `mm_only`, whose function is the padded product itself, and is printed
# beside the other as `padded product`. After the product, what every one
# of the 56 candidates surely needs on the CUDA cores: the sign test, 3
# min, 3 max and 2 compares; the reciprocal and what follows depend on the
# data. `mm_only` adds one candidate per ray and group.
OPS_SIGN_TEST, OPS_MM_ONLY = 8, 1
OPS_PRODUCT, OPS_PRODUCT_PADDED = 2 * 10 * 280, 2 * 16 * 320
GROUPS, GROUP_REPS_WIDE = 32, 4
FORM_PASSES = {"highest": (3, "tf32"), "default": (1, "bf16"),
               "split3": (3, "bf16")}
# Row E (prefilter_kernel): a unit's gate runs chunks of 8 triangles until
# one of its rays has a plausible candidate (all 7 where none has): a ray
# and chunk, two bf16 products of D, U, V, W (4 x 8 candidates over the 10
# features that are ever non-zero), then for each of the 8 candidates the
# margin test, 4 products and 8 compares; the slot test only for the rays
# of the units whose gate passed. Both counts are this run's data's.
OPS_E_PRODUCTS, OPS_MARGIN_TEST = 2 * (2 * 10 * 4 * 8), 12
# The probe: a rep is the whole (320, 16) x (16, N) product, which it
# exists to price (2 x 320 x 16 operations a column); its output needs 8
# rows of it. Checked at 8 reps (each slice of the "dyn" forms once): the
# float32 sum over reps rounds apart by about reps x 2^-24, so the 2^-20
# limit holds a few reps, not the tool's 512.
PROBE_N, PROBE_REPS, PROBE_WIDE_N, PROBE_WIDE_REPS = 1024, 512, 480000, 16
PROBE_CHECK_REPS = 8
# Phase `modes`: the legacy modes' light (an emissive sphere with its disk
# light), the soft-shadow resolution S of legacy shading (21 grid points)
# and of the legacy pathTrace (9), fold_spp's samples, and the share of
# pixels a legacy pathTrace frame may leave NaN: the reference's own (and
# the JAX package's) where a path leaves glass with its refraction stack
# drained, 0 / 0 in eta and Fresnel
LIGHT_KE = (6.0, 5.5, 5.0)
MODES_SHADING_S, MODES_PATH_S, MODES_FOLD_SPP = 4, 2, 8
MODES_NAN_SHARE = 0.05
# Timed-spp parity (16 spp in cells 2, 4 and 6): bit equality decays with
# spp, one diverged pixel's later samples all differ, so the limits bound
# the share of diverged pixels and the per-sample mean's error.
TIMED_STATE_EQ, TIMED_FRAC_OFF, TIMED_MEAN_ABS = 0.95, 0.05, 5e-3


# the tables the frame and block kernels read, and the forest kernels
# (traverse_kernel walks nodes_w; it reads nodes_f at the roots alone)
BRUTE_TABLES = ("tris", "attr", "uvt", "materials", "ell_tab", "imp_tab",
                "ell_flags", "imp_info", "atlas", "slots", "mat_maps", "sky")
FOREST_TABLES = {"brute_kernel": ("nodes_f", "nodes_i", "wf_tris", "roots"),
                 "traverse_kernel": ("nodes_w", "root_links", "wf_tris",
                                     "roots")}


class CheckFailed(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise CheckFailed(what)


def emit(record, log):
    log.append(record)
    print(json.dumps(record), flush=True)


def smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def set_peaks(n_sms):
    """Set PEAK from the card's SM count and its highest SM clock
    (nvidia-smi clocks.max.sm, MHz): for each type the larger of the data
    sheet's rate and n_sms x PER_SM_CLOCK at that clock."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True)
    mhz = float(out.stdout.split()[0])
    for kind, rate in DATA_SHEET.items():
        PEAK[kind] = max(rate, n_sms * PER_SM_CLOCK[kind] * mhz * 1e6)
    return {"sms": n_sms, "clocks_max_sm_mhz": mhz, "data_sheet": DATA_SHEET,
            "peaks": dict(PEAK)}


def ptxas_usage(text):
    """{kernel instantiation: registers and spill bytes} from nvcc's
    `-Xptxas -v` output."""
    usage, name = {}, None
    for ln in text.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
            usage[name] = {}
        elif name and "spill stores" in ln:
            words = ln.replace(",", "").split()
            usage[name]["spill_stores"] = int(words[words.index("spill") - 2])
            usage[name]["spill_loads"] = int(words[-4])
        elif name and "Used" in ln and "registers" in ln:
            words = ln.replace(",", "").split()
            usage[name]["registers"] = int(words[words.index("registers") - 1])
    return usage


def parent_trees():
    """{label: DIR} of the --parent LABEL=DIR arguments."""
    args, trees = sys.argv[1:], {}
    for i, arg in enumerate(args):
        if arg == "--parent":
            label, _, path = args[i + 1].partition("=")
            trees[label] = os.path.abspath(path)
    return trees


def load_tree(label, path):
    """The package pathtracer0_tpu_torch of the checkout at `path`, loaded
    beside this one as `tree_<label>` (it builds into its own _build/):
    {"build": ..., "frame": ..., "fused": ..., "wavefront": ...,
    "mxu_group": ..., "mm_probe": ...}."""
    import importlib
    import importlib.util

    pkg = os.path.join(path, "pathtracer0_tpu_torch")
    name = f"tree_{label}"
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return {k: importlib.import_module(f"{name}.kernels.{k}")
            for k in ("build", "frame", "fused", "wavefront", "mxu_group",
                      "mm_probe")}


# the libraries whose kernels `parent_vs_change` holds against another
# checkout's
COMPARED = ("frame_kernel", "block_kernel", "forest_kernel",
            "streamed_kernel", "mxu_group_kernel")


def differs(tree, build, lib):
    """Whether another checkout's sources of library `lib` differ from
    this checkout's (only those are built and compared)."""
    theirs, ours = tree["build"].LIBS[lib], build.LIBS[lib]
    return theirs != ours or any(
        (tree["build"].CSRC / f).read_bytes() != (build.CSRC / f).read_bytes()
        for f in ours)


def module_differs(tree, module, name):
    """Whether another checkout's kernels/<name>.py differs from this
    checkout's `module` (a wrapper that chooses a launch's shape)."""
    return (open(tree[name].__file__, "rb").read()
            != open(module.__file__, "rb").read())


# kernel -> (library, launch function) of the kernels timed by device_ms
LAUNCHERS = {"frame_kernel": ("frame_kernel", "pt_launch_frame"),
             "block_kernel": ("block_kernel", "pt_launch_block"),
             "brute_kernel": ("forest_kernel", "pt_launch_brute"),
             "traverse_kernel": ("forest_kernel", "pt_launch_traverse"),
             "streamed_kernel": ("streamed_kernel", "pt_launch_streamed"),
             "sort_key_kernel": ("streamed_kernel", "pt_launch_sort_key"),
             **{k: ("mxu_group_kernel", f"pt_launch_{k[:-len('_kernel')]}")
                for k in ("vpu_kernel", "mxu_kernel", "mxu_big_kernel",
                          "mxu_split3_kernel", "prefilter_kernel",
                          "mm_probe_kernel")}}
# the diagnostics' kernels whose `ms` is the device time of 20 launches
# back to back (device_ms), as the render kernels' (`wrapper_ms`, CUDA
# events around their wrappers, beside it): every one of them
DEVICE_TIMED = ("vpu_kernel", "mxu_kernel", "mxu_big_kernel",
                "mxu_split3_kernel", "prefilter_kernel", "mm_probe_kernel")


class KernelRepeat:
    """A loaded kernel library whose launch function `launcher`, called
    once, launches its kernel once and then `reps` times more between two
    CUDA events on the current stream, and keeps the mean in `ms`. The host
    enqueues each launch while the one before runs, so the events time the
    kernels alone."""

    def __init__(self, torch, lib, launcher, reps):
        self.torch, self.lib, self.launcher, self.reps = torch, lib, launcher, reps
        self.ms = None

    def __getattr__(self, name):
        real = getattr(self.lib, name)
        return _Repeated(real, self) if name == self.launcher else real


class _Repeated:
    """The launch function of a KernelRepeat; its ctypes attributes
    (argtypes, restype) go to the real one."""

    def __init__(self, real, owner):
        object.__setattr__(self, "real", real)
        object.__setattr__(self, "owner", owner)

    def __setattr__(self, name, value):
        setattr(self.real, name, value)

    def __call__(self, *args):
        err = self.real(*args)
        torch, owner = self.owner.torch, self.owner
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(owner.reps):
            err = err or self.real(*args)
        b.record()
        torch.cuda.synchronize()
        if not err:
            owner.ms = a.elapsed_time(b) / owner.reps
        return err


def sass_counts(build, lib):
    """{function: instructions, local loads (LDL), local stores (STL),
    calls (CALL) and their distinct targets, and the loads from device
    memory (LDG) and shared memory (LDS) by width in bits ("LDG.128": ...;
    32 where the opcode names none)} of a built library's SASS (cuobjdump
    from the toolkit of nvcc), or None without cuobjdump."""
    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    if not os.path.isfile(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(build._target(lib))],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    counts, name = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            name = ln.split("Function :")[1].strip()
            counts[name] = {"instructions": 0, "LDL": 0, "STL": 0,
                            "CALL": 0, "call_targets": set()}
        elif name and "/*" in ln and ";" in ln:
            c = counts[name]
            c["instructions"] += 1
            op = ln.split("*/", 1)[1].split(";")[0].split()
            op = [w for w in op if not w.startswith("@")]
            head = op[0].split(".") if op else [""]
            if head[0] in ("LDL", "STL", "CALL"):
                c[head[0]] += 1
                if head[0] == "CALL":
                    c["call_targets"].add(op[-1])
            elif head[0] in ("LDG", "LDS"):
                # LDG.E.128, LDS.64, LDG.E.U16 (16 bits), LDG.E (32)
                width = next((w.lstrip("US") for w in head[1:]
                              if w.lstrip("US").isdigit()), "32")
                key = f"{head[0]}.{width}"
                c[key] = c.get(key, 0) + 1
    for c in counts.values():
        c["call_targets"] = len(c["call_targets"])
    return counts


def profile_route(Renderer, cfg, label, scene, info, cam, card, log):
    """One 800x600 frame of the per-bounce route under torch.profiler
    (tools/profile.trace_busy)."""
    from pathtracer0_tpu_torch.tools.profile import trace_busy

    r = Renderer(scene, info, cfg, cam_pos=cam[0], cam_rot=cam[1], seed=2,
                 device="cuda")
    emit({"phase": "profile", "scene": label,
          "spp": cfg.samples_per_frame, "bounces": cfg.max_bounces,
          **trace_busy(r.step), "card": card}, log)


def session(torch, np, dev, card, log, zero_counts, scenes, RenderConfig,
            Renderer, frame, wavefront, cpu_scenes, card_scenes):
    """Phase 6, `session`: the renderer as a user drives it on the card,
    each part with the launch counts set to 0 just before it and read just
    after. hero: config 5 at 1920x1080x8 through Renderer.render(frames=2,
    chunk=2), a warm-up and a timed call (bench.py's hero metrics);
    checkpoint: save, load in a fresh Renderer of the same seed, one
    step() each, display images bit-equal; pick: 3 x 3 pixels around the
    centre against the CPU's pick of the same scene in config 3, the OBJ
    grid and the 1M terrain; driver: tests/test_driver.py's scripted
    session on config 3 at 800x600x8; cli: python -m pathtracer0_tpu_torch
    --scene 3 --frames 4 with a stdin that stays open."""
    from pathtracer0_tpu_torch.render.driver import FrameLoopDriver

    t_start = time.perf_counter()
    rec = {"phase": "session", "card": card}
    tmp = tempfile.mkdtemp()

    # hero (bench.py:155-177)
    zero_counts()
    sc, info = scenes.BUILDERS[5]().build(max_leaf=4, device="cuda")
    cam, rot = scenes.CAMERAS[5]
    cfg = RenderConfig(width=1920, height=1080, samples_per_frame=8,
                       max_bounces=6, auto_focus=False, blur=0.001)
    r = Renderer(sc, info, cfg, cam_pos=cam, cam_rot=rot, device="cuda")
    frames = 2
    r.render(frames=frames, chunk=frames)
    rays0 = r.rays_traced
    t0 = time.perf_counter()
    r.render(frames=frames, chunk=frames)
    rays1 = r.rays_traced
    dt = (time.perf_counter() - t0) / frames
    rec["hero"] = {
        "shape": [1920, 1080, 8, 6], "frames": frames, "frame_s": dt,
        "mrays_per_s": (rays1 - rays0) / frames / dt / 1e6,
        "samples_per_s": 1920 * 1080 * 8 / dt,
        "est_time_to_4096spp_s": 4096 / 8 * dt,
        "launches": frame.trace_frame.launches,
        "finite": bool(torch.isfinite(r.display_image()).all())}
    check(rec["hero"]["finite"], f"hero: image not finite {rec['hero']}")
    check(rec["hero"]["launches"] == 2 * frames, f"hero: {rec['hero']}")

    # checkpoint: the same kernel on the same inputs gives the same bits
    zero_counts()
    path = os.path.join(tmp, "hero.npz")
    r.save_checkpoint(path)
    resumed = Renderer(sc, info, cfg, cam_pos=cam, cam_rot=rot,
                       device="cuda")
    resumed.load_checkpoint(path)
    loaded_equal = bool(torch.equal(r.display_image(),
                                    resumed.display_image()))
    a, b = r.step(), resumed.step()
    rec["checkpoint"] = {
        "loaded_equal": loaded_equal, "step_equal": bool(torch.equal(a, b)),
        "max_abs_diff": float((a - b).abs().max()),
        "count": resumed._count, "seed_draws": resumed._seed_draws,
        "launches": frame.trace_frame.launches}
    check(rec["checkpoint"]["loaded_equal"]
          and rec["checkpoint"]["step_equal"]
          and resumed._seed_draws == r._seed_draws == 2 * frames + 1,
          f"checkpoint: resume not bit-equal {rec['checkpoint']}")
    del r, resumed

    # pick: the card against the CPU on the same scene
    rec["pick"] = {}
    for label, (host, host_info, (cam, rot), kw) in cpu_scenes.items():
        zero_counts()
        cfg = RenderConfig(width=800, height=600, **kw)
        on_card = Renderer(*card_scenes[label], cfg, cam_pos=cam,
                           cam_rot=rot, device="cuda")
        on_cpu = Renderer(host, host_info, cfg, cam_pos=cam, cam_rot=rot,
                          device="cpu")
        worst, kinds = {"distance": 0.0, "normal": 0.0, "loc": 0.0}, []
        for dy in (-60, 0, 60):
            for dx in (-100, 0, 100):
                pk, pc = on_card.pick(400 + dx, 300 + dy), \
                    on_cpu.pick(400 + dx, 300 + dy)
                for key in ("hit", "kind", "obj", "material"):
                    check(pk[key] == pc[key],
                          f"pick {label} ({dx}, {dy}) {key}: {pk} {pc}")
                t = pc["distance"]
                worst["distance"] = max(worst["distance"], abs(
                    pk["distance"] - t) / (1.0 + abs(t)))
                for key in ("normal", "loc"):
                    worst[key] = max(worst[key], float(
                        np.abs(pk[key] - pc[key]).max()
                        / (1.0 + np.abs(pc["loc"]).max())))
                kinds.append(pc["kind"])
        launches = {"brute_kernel": wavefront.launches["brute_kernel"],
                    "traverse_kernel": wavefront.launches["traverse_kernel"],
                    "streamed_kernel": wavefront.launches["streamed_kernel"]}
        rec["pick"][label] = {"relative_err": worst, "kinds": kinds,
                              "launches": launches}
        check(all(v <= 1e-5 for v in worst.values()),
              f"pick {label}: {worst}")
        mesh = kinds.count(1)
        check(sum(launches.values()) == (9 if host_info.num_tris else 0)
              and (mesh > 0) == bool(host_info.num_tris),
              f"pick {label}: {rec['pick'][label]}")
    check(rec["pick"]["terrain_1m"]["launches"]["streamed_kernel"] == 9
          and rec["pick"]["obj_grid"]["launches"]["streamed_kernel"] == 0,
          f"pick: routes {rec['pick']}")

    # driver: tests/test_driver.py's scripted session, timed by tick
    zero_counts()
    sc, info = card_scenes["config3"]
    cam, rot = scenes.CAMERAS[3]
    drv = FrameLoopDriver(sc, info, RenderConfig(width=800, height=600,
                                                 samples_per_frame=8),
                          cam_pos=cam, cam_rot=rot, auto_screenshot_after=3,
                          screenshot_dir=os.path.join(tmp, "shots"),
                          preview_frames=2, device="cuda")
    ticks, real_tick = [], drv.tick

    def timed_tick():
        quality = "preview" if drv.moving else "full"
        t0 = time.perf_counter()
        img = real_tick()
        torch.cuda.synchronize()
        ticks.append((quality, 1e3 * (time.perf_counter() - t0)))
        return img

    drv.tick = timed_tick
    replies = drv.run_script(
        [None, "move 0 0 0.5", None, None, None, "screenshot end.png"],
        trailing_frames=1)
    rec["driver"] = {
        "replies": [os.path.relpath(x, tmp) for x in replies],
        "auto_screenshot": os.path.basename(drv.last_screenshot or ""),
        "full_count": drv.renderer._count,
        "preview_count": drv.preview_renderer._count,
        "frames": drv.renderer._frame_index
        + drv.preview_renderer._frame_index,
        "tick_ms": ticks,
        "preview_tick_ms": [ms for q, ms in ticks if q == "preview"][-1],
        "full_tick_ms": [ms for q, ms in ticks if q == "full"][-1],
        "launches": frame.trace_frame.launches}
    check(replies == [os.path.join(tmp, "shots", "end.png")]
          and os.path.exists(replies[0])
          and drv.renderer._count == 4 and drv.preview_renderer._count == 2
          and rec["driver"]["auto_screenshot"].startswith("autoScreenshot_3_")
          and rec["driver"]["launches"] == len(ticks) == 7,
          f"driver: {rec['driver']}")

    # cli: a subprocess on the card, its stdin a pipe that stays open
    env = dict(os.environ, PYTHONPATH=ROOT)
    with open(os.path.join(tmp, "cli.err"), "w+") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "pathtracer0_tpu_torch", "--scene", "3",
             "--frames", "4", "--out", os.path.join(tmp, "cli")],
            cwd=ROOT, env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=err, text=True)
        try:
            out = proc.stdout.read()
            rc = proc.wait(timeout=300)
        finally:
            proc.stdin.close()
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        err.seek(0)
        tail = err.read()[-2000:]
    lines = out.splitlines()
    rec["cli"] = {"rc": rc, "stdout": lines, "stderr_tail": tail}
    check(rc == 0 and len(lines) == 2
          and lines[0].startswith("scene built in ")
          and lines[1].startswith("4 frames in "), f"cli: {rec['cli']}")
    shutil.rmtree(tmp, ignore_errors=True)
    rec["seconds"] = time.perf_counter() - t_start
    emit(rec, log)
    return rec


def modes(c):
    """Phase 7, `modes`: the render modes that never take the frame path,
    each through the entry point a user calls, at 800x600 on the card:
    legacy shading (Whitted, S = 4) and the legacy pathTrace (S = 2, 6
    bounces) on the terrain (traverse_kernel) and on the OBJ grid
    (brute_kernel), each with an emissive sphere as its light; fold_spp
    through render_rays on the terrain at 8 spp (one query of 3.84 M
    rays a bounce); the debug heatmap on a two-object forest (the terrain
    and the OBJ grid: traverse_kernel once per object) and on the 1M
    terrain (streamed_kernel).

    Each run: a warm-up frame, the launch counts set to 0, 2 timed frames
    (wall and CUDA-event ms), the counts read (launches per frame by
    kernel; of the legacy modes also what one query per grid point would
    launch), then one frame under torch.profiler (the card's busy share,
    as --profile reports it). Then the same render at 160x120 and the
    same seed on the card against the CPU route (the plain versions):
    as the goldens are made (no blur, no autofocus): at S = 0 (legacy
    modes only) pixels within 1e-4 on >= 99.9%, at the run's S or spp the
    golden RMSE < 0.05, the heatmap within 1e-6 on >= 99.9%; NaN pixels
    (the reference's drained refraction stack) count as agreeing where
    both have them; the pathTrace's pixels that followed a glossy
    refraction (whose location hash turns a libm ulp into another path)
    stand under the RMSE alone, their share recorded. The heatmap's
    counters on the 800x600 rays against the plain walks
    (traverse_reference per object, streamed_reference): equal on
    >= 99.9% of rays."""
    torch, np = c.torch, c.np
    from pathtracer0_tpu_torch.core import rng as vrng
    from pathtracer0_tpu_torch.kernels import fused, traverse
    from pathtracer0_tpu_torch.kernels.intersect import MISS
    from pathtracer0_tpu_torch.render.renderer import render_debug_frame
    from pathtracer0_tpu_torch.shade import arealights
    from pathtracer0_tpu_torch.tools.profile import trace_busy

    t_start = time.perf_counter()
    dev = c.dev
    (w, h), (w_s, h_s) = c.size, c.small
    tmp = tempfile.mkdtemp()

    def on_card(host):
        sc, info = host[:2]
        return dataclasses.replace(sc, **{
            f.name: getattr(sc, f.name).to(dev)
            for f in dataclasses.fields(sc)}), info

    built = {}
    t0 = time.perf_counter()
    host = c.terrain_scene(light=True, device="cpu")[:2]
    built["terrain"] = (*on_card(host), *host, c.terrain_cam)
    host = c.grid_scene(tmp, device="cpu", light=True)
    built["obj_grid"] = (*on_card(host), *host, c.grid_cam)
    host = c.terrain_scene(obj=c.grid_obj(tmp), device="cpu")[:2]
    built["forest2"] = (*on_card(host), *host, c.terrain_cam)
    built["terrain_1m"] = (c.big, c.big_info, *c.big_host, c.big_cam)
    build_s = time.perf_counter() - t0
    check(built["forest2"][1].num_objects == 2
          and not c.wavefront.use_brute(built["forest2"][1])
          and built["terrain"][1].lights and built["obj_grid"][1].lights,
          "modes: the scenes are not the ones described")

    def counts():
        return {"frame_kernel": c.frame.trace_frame.launches,
                "block_kernel": fused.trace_block.launches,
                "bounce_kernel": c.bounce.bounce_step.launches,
                CAMERA: c.bounce.camera_step.launches,
                **c.wavefront.launches}

    class Folded:
        """render_rays(fold_spp=True) over a whole frame behind
        Renderer's step(), rays_traced and display_image()."""

        def __init__(self, sc, info, cfg, cam, device):
            self.sc, self.info, self.cfg = sc, info, cfg
            self.device, self.seed, self.queries = device, 1, 0
            self.pose = [torch.tensor(v, dtype=torch.float32, device=device)
                         for v in cam]
            self.uv, self.index = c.camera.pixel_centers(cfg.width,
                                                         cfg.height, device)
            self.ifd = c.autofocus_distance(sc, info, *self.pose,
                                            cfg.focal_distance, True)

        def step(self, frame_seed=None):
            self.seed += 1
            self.image, q = c.render_rays(
                self.sc, self.info, self.uv, self.index, *self.pose,
                self.seed if frame_seed is None else frame_seed, self.ifd,
                config=self.cfg, fold_spp=True)
            self.queries = self.queries + q

        @property
        def rays_traced(self):
            return int(self.queries)

        def display_image(self):
            return self.image.reshape(self.cfg.height, self.cfg.width, 3)

    def small_render(mode, sc, info, cfg, cam, device):
        """One 160x120 frame (seed GOLDEN's) as a numpy image, and of the
        legacy pathTrace the pixels that followed a glossy refraction (its
        rays made as render_rays makes them, the frame checked equal to
        render_frame's on the card)."""
        seed = GOLDEN[3]
        if mode == "legacy_pathtrace":
            uv, index = c.camera.pixel_centers(cfg.width, cfg.height, device)
            pose = [torch.tensor(v, dtype=torch.float32, device=device)
                    for v in cam]
            rotmat = c.vm.rotation_matrix(pose[1])
            state = vrng.seed(index, seed)
            o, d, state = c.camera.dof_ray(
                pose[0], c.camera.primary_directions(
                    uv, rotmat, cfg.cam_size, cfg.focal_length,
                    cfg.screen_h_ratio), rotmat, cfg.blur,
                torch.tensor(cfg.focal_distance, device=device), state)
            glossy = torch.zeros(index.shape, dtype=torch.bool,
                                 device=device)
            col = arealights.path_trace(
                o.unbind(-1), d.unbind(-1), state, sc, info,
                cfg.samples_per_frame, cfg.max_bounces,
                stack_size=cfg.refraction_stack_depth, glossy=glossy)[0]
            img = torch.stack(col, -1).reshape(cfg.height, cfg.width, 3)
            if torch.device(device).type == "cuda":
                ref = c.render_frame(sc, info, cfg, *cam, seed,
                                     device=device)[0]
                check(bool(((img == ref) | (torch.isnan(img)
                                            & torch.isnan(ref))).all()),
                      "modes: the pathTrace's rays are not render_frame's")
            return img.cpu().numpy(), glossy.reshape(
                cfg.height, cfg.width).cpu().numpy()
        if mode == "fold_spp":
            r = Folded(sc, info, cfg, cam, device)
            r.step(seed)
            img = r.display_image()
        elif mode == "debug":
            img = render_debug_frame(sc, info, cfg, *cam, device=device)
        else:
            img = c.render_frame(sc, info, cfg, *cam, seed,
                                 device=device)[0]
        return img.cpu().numpy(), None

    def agreement(a, b, tol, glossy):
        """Pixels within `tol` (or NaN in both) and NaN in both or
        neither, as shares of the pixels no glossy refraction reached
        (the location hash turns a libm ulp between the devices into
        another path: those pixels stand under the image budget, the
        RMSE over every pixel finite in both)."""
        nan_a, nan_b = np.isnan(a).any(-1), np.isnan(b).any(-1)
        both = ~nan_a & ~nan_b
        steady = ~glossy
        diff = np.where(both, np.abs(np.where(both[..., None], a - b, 0.0))
                        .max(-1), np.inf)
        return {"within": float(((diff < tol) | (nan_a & nan_b))[steady]
                                .mean()),
                "rmse": c.img_util.rmse(np.clip(a[both], 0.0, 1.0),
                                        np.clip(b[both], 0.0, 1.0)),
                "nan_agree": float((nan_a == nan_b)[steady].mean()),
                "nan_pixels": [int(nan_a.sum()), int(nan_b.sum())],
                "glossy_share": float(glossy.mean()),
                "within_glossy": float(((diff < tol) | (nan_a & nan_b))
                                       [glossy].mean()) if glossy.any()
                else None,
                "max_abs_err": float(diff[both & steady].max())
                if (both & steady).any() else 0.0}

    base = dict(width=w, height=h, max_bounces=BOUNCES)
    terrain_kw = dict(auto_focus=True)
    grid_kw = dict(auto_focus=False, focal_distance=5.0)
    runs = (
        ("legacy_shading", "terrain", "traverse_kernel",
         dict(raytracing=False, legacy_shading=True,
              samples_per_frame=MODES_SHADING_S, **terrain_kw)),
        ("legacy_shading", "obj_grid", "brute_kernel",
         dict(raytracing=False, legacy_shading=True,
              samples_per_frame=MODES_SHADING_S, **grid_kw)),
        ("legacy_pathtrace", "terrain", "traverse_kernel",
         dict(legacy_pathtrace=True, samples_per_frame=MODES_PATH_S,
              **terrain_kw)),
        ("legacy_pathtrace", "obj_grid", "brute_kernel",
         dict(legacy_pathtrace=True, samples_per_frame=MODES_PATH_S,
              **grid_kw)),
        ("fold_spp", "terrain", "traverse_kernel",
         dict(samples_per_frame=MODES_FOLD_SPP, **terrain_kw)),
        ("debug", "forest2", "traverse_kernel",
         dict(debug=True, auto_focus=False)),
        ("debug", "terrain_1m", "streamed_kernel",
         dict(debug=True, auto_focus=False)))
    recs = {}
    for mode, label, kernel, kw in runs:
        sc, info, host_sc, host_info, cam = built[label]
        cfg = c.RenderConfig(**{**base, **kw})
        if mode == "fold_spp":
            r = Folded(sc, info, cfg, cam, dev)
        else:
            r = c.Renderer(sc, info, cfg, cam_pos=cam[0], cam_rot=cam[1],
                           seed=7, device=dev)
        r.step()
        torch.cuda.synchronize()
        c.zero_counts()
        q0, walls, events = r.rays_traced, [], []
        for _ in range(2):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t = time.perf_counter()
            a.record()
            r.step()
            b.record()
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t))
            events.append(a.elapsed_time(b))
        per_frame = {k: v / 2 for k, v in counts().items() if v}
        img = r.display_image()
        nan_share = float(torch.isnan(img).any(-1).float().mean())
        rec = {"phase": "modes", "mode": mode, "scene": label,
               "tris": info.num_tris, "objects": info.num_objects,
               "width": w, "height": h,
               "spp": cfg.samples_per_frame, "bounces": cfg.max_bounces,
               "wall_ms": walls, "cuda_ms": events,
               "queries_per_frame": (r.rays_traced - q0) / 2,
               "launches_per_frame": per_frame, "kernel": kernel,
               "nan_share": nan_share,
               "finite_share": float(torch.isfinite(img).all(-1).float()
                                     .mean()),
               "card": c.card}
        if mode.startswith("legacy"):
            # what the JAX package's one query per grid point would launch
            grid = len(arealights.grid_points(cfg.samples_per_frame))
            shades = (1 if mode == "legacy_shading"
                      else (per_frame.get(kernel, 0) - 1) // 2)
            rec["grid_points"] = grid
            rec["launches_per_frame_one_per_point"] = (
                per_frame.get(kernel, 0)
                + shades * len(info.lights) * (grid - 1))
        rec["profile"] = trace_busy(r.step)
        rec["busy_share"] = rec["profile"]["busy_share"]
        # the same render at 160x120 on the card and on the CPU, as the
        # goldens are made: no blur, no autofocus (libm ulps in the lens
        # draws or the probe would move every ray)
        small = c.RenderConfig(**{**base, **kw, "width": w_s,
                                  "height": h_s, "blur": 0.0,
                                  "auto_focus": False})
        variants = [("run", small)]
        if mode.startswith("legacy"):
            variants.append(("s0", dataclasses.replace(small,
                                                       samples_per_frame=0)))
        rec["vs_cpu"] = {}
        for name, cfg_s in variants:
            got, glossy_k = small_render(mode, sc, info, cfg_s, cam, dev)
            want, glossy_p = small_render(mode, host_sc, host_info, cfg_s,
                                          cam, "cpu")
            glossy = (np.zeros(got.shape[:2], bool) if glossy_k is None
                      else glossy_k | glossy_p)
            tol = 1e-6 if mode == "debug" else 1e-4
            rec["vs_cpu"][name] = {"spp": cfg_s.samples_per_frame,
                                   **agreement(got, want, tol, glossy)}
        recs[f"{mode} {label}"] = rec
        # checks: only the run's kernel, as often as the mode needs it
        # (fold_spp's bounces also launch bounce_kernel, once each); the
        # camera form once a frame where the mode makes camera rays (its
        # one sample of spp x N rays, or the legacy modes' one
        # evaluation), never for the heatmap's undeflected rays
        others = {k: v for k, v in per_frame.items() if k != kernel
                  and not (mode == "fold_spp" and k == "bounce_kernel")
                  and k != CAMERA and k != "sort_key_kernel"}
        n_kernel = per_frame.get(kernel, 0)
        # a streamed query of the frame's rays is the sorted one
        check(per_frame.get("sort_key_kernel", 0)
              == (n_kernel if kernel == "streamed_kernel" else 0),
              f"modes {mode} {label}: sort-key launches {per_frame}")
        check(mode != "fold_spp"
              or per_frame.get("bounce_kernel") == n_kernel,
              f"modes {mode} {label}: bounce launches {per_frame}")
        check(per_frame.get(CAMERA, 0) == (0 if mode == "debug" else 1),
              f"modes {mode} {label}: camera form launches {per_frame}")
        want_n = {"legacy_shading": 1 + len(info.lights),
                  "debug": max(info.num_objects, 1)}.get(mode)
        check(not others and n_kernel > 0
              and (want_n is None or n_kernel == want_n)
              and n_kernel <= 1 + 4 * BOUNCES,
              f"modes {mode} {label}: launches {per_frame}")
        check(nan_share <= (MODES_NAN_SHARE if mode == "legacy_pathtrace"
                            else 0.0),
              f"modes {mode} {label}: NaN pixels {nan_share}")
        run = rec["vs_cpu"]["run"]
        if mode == "debug":
            check(run["within"] >= 0.999,
                  f"modes {mode} {label}: against the CPU {run}")
        else:
            check(run["rmse"] < 0.05 and run["nan_agree"] >= 0.999,
                  f"modes {mode} {label}: against the CPU {run}")
        if "s0" in rec["vs_cpu"]:
            s0 = rec["vs_cpu"]["s0"]
            check(s0["within"] >= 0.999,
                  f"modes {mode} {label}: S = 0 against the CPU {s0}")

        # the heatmap's counters against the plain walks, on the card
        if mode == "debug":
            uv, _ = c.camera.pixel_centers(w, h, dev)
            pose = [torch.tensor(v, dtype=torch.float32, device=dev)
                    for v in cam]
            d = c.camera.primary_directions(
                uv, c.vm.rotation_matrix(pose[1]), cfg.cam_size,
                cfg.focal_length, cfg.screen_h_ratio).unbind(-1)
            o = tuple(pose[0][i].expand(w * h) for i in range(3))
            on = traverse.nudged(o, d)
            miss = torch.full((w * h,), MISS, device=dev)
            rec["counters_equal"] = {}
            if info.streamed:
                box, rows = traverse.heat_counts(o, d, sc, info)
                out = c.wavefront.streamed_reference(on, d, miss, sc, info)
                rec["counters_equal"]["lbvh"] = {
                    "box": float((box == out[4]).float().mean()),
                    "rows": float((rows == out[5]).float().mean()),
                    "rows_per_ray": float(rows.float().mean())}
            for k in range(info.num_objects):
                box, leaf = traverse.object_heat_counts(o, d, sc, info, k)
                out = c.wavefront.traverse_reference(on, d, miss, sc, info,
                                                     objects=(k,))
                rec["counters_equal"][f"object {k}"] = {
                    "box": float((box == out[4]).float().mean()),
                    "leaf": float((leaf == out[5]).float().mean()),
                    "leaves_per_ray": float(leaf.float().mean())}
            check(rec["counters_equal"] and all(
                v >= 0.999 for cell in rec["counters_equal"].values()
                for key, v in cell.items() if key in ("box", "leaf", "rows")),
                f"modes {mode} {label}: counters {rec['counters_equal']}")
        emit(rec, c.log)
    shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "modes", "summary": True, "build_s": build_s,
          "seconds": time.perf_counter() - t_start, "card": c.card}, c.log)
    return recs


def obj_phase(c):
    """Phase 8, `obj`: the native OBJ parser on the card's machine.
    scenes.terrain(BIG_N)'s 999,698 triangles written as one OBJ (`o
    terrain`, `v` in %.17g, `f` in the mesh's vertex order, no vt or vn:
    about 50 MB, so Scene.add_object picks the native parser by size),
    timed through add_object and build() (streamed); its packed tables
    against the add_mesh_indexed build of the same mesh, field by field to
    every bit (the UV fields may differ: the OBJ's sentinel against
    add_mesh's zeros, and no triangle has UVs); one Whitted and one path
    frame of each through Renderer at 800x600, BIG_SPP spp, BIG_BOUNCES
    bounces, no autofocus, blur 0 (streamed_kernel): pixels equal on >=
    99.9%. Then the n = 181 terrain (64,800 faces) as an OBJ through both
    parsers (PT0_NATIVE_OBJ=1 and 0), both parse times, the packed tables
    equal to every bit."""
    torch, np = c.torch, c.np
    t_start = time.perf_counter()
    check(os.environ.get("PT0_NATIVE_OBJ") is None,
          "obj: PT0_NATIVE_OBJ must be unset, the file's size picks the "
          "parser")
    tmp = tempfile.mkdtemp()
    rec = {"phase": "obj", "card": c.card}

    def write_obj(path, verts, faces):
        with open(path, "w") as f:
            f.write("o terrain\n")
            np.savetxt(f, verts, fmt="v %.17g %.17g %.17g")
            np.savetxt(f, faces + 1, fmt="f %d %d %d")

    def parts(sc):
        """The packed tables by field; attr and uvt split by meaning."""
        out = {}
        for f in dataclasses.fields(sc):
            t = getattr(sc, f.name)
            if f.name == "attr":
                out["attr normals"], out["attr material, smooth"] = \
                    t[:, :9], t[:, 9]
            elif f.name == "uvt":
                out["uvt uv"], out["uvt tangent, has_uv"] = t[:, :6], t[:, 6:]
            else:
                out[f.name] = t
        return out

    def fields_equal(a, b):
        pa, pb = parts(a), parts(b)
        return {k: bool(pa[k].shape == pb[k].shape
                        and torch.equal(pa[k], pb[k])) for k in pa}

    def load(path, force=None):
        """The terrain's materials and the OBJ, parsed with PT0_NATIVE_OBJ
        set to `force` (None: by size): (Scene, parse seconds)."""
        sc = c.scenes.terrain_materials(c.Scene())
        if force is not None:
            os.environ["PT0_NATIVE_OBJ"] = force
        try:
            t0 = time.perf_counter()
            sc.add_object(path)
            return sc, time.perf_counter() - t0
        finally:
            os.environ.pop("PT0_NATIVE_OBJ", None)

    # the 1M terrain: chosen by size, streamed, against add_mesh_indexed
    path = os.path.join(tmp, "terrain_1m.obj")
    t0 = time.perf_counter()
    write_obj(path, *c.scenes.terrain_mesh(BIG_N))
    write_s = time.perf_counter() - t0
    size = os.path.getsize(path)
    sc, parse_s = load(path)
    native = len(sc.bulk_meshes) == 1 and len(sc.tris) == 0
    t0 = time.perf_counter()
    obj, obj_info = sc.build()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    equal = fields_equal(obj, c.big)
    big = {"faces": obj_info.num_tris, "bytes": size, "write_s": write_s,
           "parse_s": parse_s, "faces_per_s": obj_info.num_tris / parse_s,
           "build_s": build_s, "native": native,
           "info_equal": obj_info == c.big_info,
           "fields_equal": equal,
           "fields_differing": [k for k, v in equal.items() if not v]}
    check(native and size > c.Scene.NATIVE_OBJ_THRESHOLD,
          f"obj: the 1M OBJ did not take the native parser {big}")
    check(obj_info.streamed and big["info_equal"]
          and set(big["fields_differing"]) <= {"uvt uv"},
          f"obj: the OBJ's tables differ from add_mesh_indexed's {big}")
    big["frames"] = {}
    for raytracing in (True, False):
        cfg = c.RenderConfig(width=800, height=600,
                             samples_per_frame=BIG_SPP,
                             max_bounces=BIG_BOUNCES, raytracing=raytracing,
                             auto_focus=False, blur=0.0)
        imgs, launches = [], {}
        for label, (s, info) in (("obj", (obj, obj_info)),
                                 ("indexed", (c.big, c.big_info))):
            r = c.Renderer(s, info, cfg, cam_pos=c.big_cam[0],
                           cam_rot=c.big_cam[1], seed=5, device="cuda")
            c.zero_counts()
            imgs.append(r.step())
            torch.cuda.synchronize()
            launches[label] = c.counts()
        eq = float((imgs[0] == imgs[1]).all(-1).float().mean())
        mode = "path" if raytracing else "whitted"
        big["frames"][mode] = {"pixels_equal": eq, "launches": launches}
        n_max = BIG_SPP * (BIG_BOUNCES if raytracing else 1)
        check(eq >= 0.999 and all(
            set(n) == {"streamed_kernel", "sort_key_kernel", "bounce_kernel",
                       CAMERA}
            and 0 < n["streamed_kernel"] <= n_max
            and n["sort_key_kernel"] == n["streamed_kernel"]
            and n["bounce_kernel"] == n["streamed_kernel"]
            and n[CAMERA] == BIG_SPP
            for n in launches.values()),
            f"obj: {mode} frames {big['frames'][mode]}")
    rec["terrain_1m"] = big
    del obj, sc

    # the n = 181 terrain: both parsers of the same OBJ, streamed builds
    path = os.path.join(tmp, "terrain_181.obj")
    write_obj(path, *c.scenes.terrain_mesh(TERRAIN_N))
    cfg = c.RenderConfig(stream_threshold=0)
    built, seconds = {}, {}
    for label, force in (("native", "1"), ("python", "0")):
        sc, seconds[label] = load(path, force)
        built[label] = sc.build(cfg)
    equal = fields_equal(built["native"][0], built["python"][0])
    small = {"faces": built["native"][1].num_tris, "parse_s": seconds,
             "speedup": seconds["python"] / seconds["native"],
             "info_equal": built["native"][1] == built["python"][1],
             "fields_differing": [k for k, v in equal.items() if not v]}
    check(small["faces"] == 2 * (TERRAIN_N - 1) ** 2 and small["info_equal"]
          and not small["fields_differing"],
          f"obj: the two parsers' tables differ {small}")
    rec["terrain_181"] = small
    shutil.rmtree(tmp, ignore_errors=True)
    rec["seconds"] = time.perf_counter() - t_start
    emit(rec, c.log)
    return rec


# phase `dist`: the hero's settings (phase `session`'s), its frame seed,
# and how long the two processes on the card may take
HERO = dict(width=1920, height=1080, samples_per_frame=8, max_bounces=6,
            auto_focus=False, blur=0.001)
DIST_SEED, DIST_TIMEOUT_S = 4242, 120


def dist_worker(rank, addr, world, out_dir):
    """One rank of phase `dist`'s two processes on cuda:0: joins the
    process group over gloo, renders its row slab of the config-5 hero and
    assembles the image with one all-gather; writes its record, and rank
    0 the image, into `out_dir`."""
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    import torch.distributed as torch_dist

    from pathtracer0_tpu_torch import RenderConfig, scenes
    from pathtracer0_tpu_torch.dist import multihost
    from pathtracer0_tpu_torch.kernels import fused

    torch.cuda.set_device(0)
    check(multihost.initialize(addr, world, rank, backend="gloo"),
          "dist: initialize did not join the process group")
    sc, info = scenes.BUILDERS[5]().build(max_leaf=4, device="cuda")
    cam, rot = scenes.CAMERAS[5]
    slab, queries = multihost.render_local_slab(
        sc, info, RenderConfig(**HERO), cam, rot, DIST_SEED,
        multihost.local_mesh(["cuda:0"]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    full = multihost.assemble_image(slab, HERO["height"])
    gather_ms = 1e3 * (time.perf_counter() - t0)
    if rank == 0:
        np.save(os.path.join(out_dir, "assembled.npy"), full)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"rank": rank, "rows": multihost.local_rows(HERO["height"]),
                   "slab_shape": list(slab.shape), "queries": int(queries),
                   "all_gather_ms": gather_ms,
                   "launches": {"block_kernel": fused.trace_block.launches}},
                  f)
    torch_dist.destroy_process_group()


def dist_phase(c, session_rec):
    """Phase 9, `dist`: dist/mesh.py and dist/multihost.py on the card,
    each run with the launch counts set to 0 just before it and read just
    after. hero: config 5 at 1920x1080x8, 6 bounces, blur 0.001, no
    autofocus; render_frame_tiled over [cuda:0] * 4 against one
    render_rays over the whole image (block_kernel): elements bit-equal on
    >= 99.9%, queries equal but for the pad pixels' own. terrain: the 1M
    terrain the same way at 800x600, BIG_SPP spp, BIG_BOUNCES bounces
    (streamed_kernel). sample split: config 2 at 800x600x16 over
    [cuda:0] * 2 against the mean of two render_rays calls with seeds s
    and s + 2654435761 (mod 2^32), to every bit; at 160x120, 2 spp a
    device, golden RMSE < 0.05. DistributedRenderer on the hero over
    [cuda:0] * 4: a warm-up and two timed frames (Mrays/s, wall and CUDA
    ms, beside phase `session`'s frame-path hero); a checkpoint loaded
    into a fresh instance, display images bit-equal after one more step;
    move_camera resets the count; then one frame under torch.profiler (the
    card's busy share, the kernels' device time). Two processes on cuda:0
    over gloo (torch.multiprocessing, a free TCP port, DIST_TIMEOUT_S),
    each its 540-row slab of the hero: rank 0's assembled image against
    the single-process render, >= 99.9% of elements equal, the all-gather's
    ms. With more than one card, a mesh of two cards against one card."""
    torch, np = c.torch, c.np
    import socket

    import torch.multiprocessing as mp

    from pathtracer0_tpu_torch.dist import mesh as dmesh
    from pathtracer0_tpu_torch.tools.profile import trace_busy

    t_start = time.perf_counter()
    dev = c.dev
    rec = {"phase": "dist", "card": c.card}
    tmp = tempfile.mkdtemp()
    sc5, info5 = c.scenes.BUILDERS[5]().build(max_leaf=4, device="cuda")
    cam5 = c.scenes.CAMERAS[5]
    hero_cfg = c.RenderConfig(**HERO)

    def untiled(sc, info, cfg, cam, seed):
        """One render_rays call over the whole image on the card."""
        pos, rot = (torch.tensor(v, dtype=torch.float32, device=dev)
                    for v in cam)
        uv, index = c.camera.pixel_centers(cfg.width, cfg.height, dev)
        ifd = c.autofocus_distance(sc, info, pos, rot, cfg.focal_distance,
                                   cfg.auto_focus)
        col, q = c.render_rays(sc, info, uv, index, pos, rot, seed, ifd,
                               config=cfg)
        return col.reshape(cfg.height, cfg.width, 3), int(q)

    def chunks(n, cfg):
        return -(-n // cfg.ray_batch_size)

    def tiled_vs_untiled(sc, info, cfg, cam, mesh, kernel):
        n = cfg.width * cfg.height
        c.zero_counts()
        t0 = time.perf_counter()
        img_t, q_t = dmesh.render_frame_tiled(sc, info, cfg, cam[0], cam[1],
                                              DIST_SEED, mesh)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
        launches_t = c.counts()
        c.zero_counts()
        t0 = time.perf_counter()
        img_u, q_u = untiled(sc, info, cfg, cam, DIST_SEED)
        torch.cuda.synchronize()
        wall_u = 1e3 * (time.perf_counter() - t0)
        launches_u = c.counts()
        n_pad = -n % len(mesh)
        q_pad = 0
        if n_pad:
            q_pad = int(c.render_rays(
                sc, info, torch.zeros((n_pad, 2), device=dev),
                torch.zeros(n_pad, dtype=torch.int64, device=dev),
                torch.tensor(cam[0], dtype=torch.float32, device=dev),
                torch.tensor(cam[1], dtype=torch.float32, device=dev),
                DIST_SEED, torch.tensor(cfg.focal_distance, device=dev),
                config=cfg)[1])
        r = {"shape": [cfg.width, cfg.height, cfg.samples_per_frame,
                       cfg.max_bounces], "mesh": [str(d) for d in mesh],
             "elements_equal": float((img_t == img_u).float().mean()),
             "queries_tiled": int(q_t), "queries_untiled": q_u,
             "pad_pixels": n_pad, "pad_queries": q_pad,
             "wall_ms_tiled": wall, "wall_ms_untiled": wall_u,
             "launches_tiled": launches_t, "launches_untiled": launches_u,
             "finite": bool(torch.isfinite(img_t).all())}
        # the camera form once a sample of each tile and chunk
        tile = (n + n_pad) // len(mesh)
        r["camera_launches_expected"] = [
            len(mesh) * cfg.samples_per_frame * chunks(tile, cfg),
            cfg.samples_per_frame * chunks(n, cfg)]
        ok = [launches_t.get(CAMERA), launches_u.get(CAMERA)] == r[
            "camera_launches_expected"]
        if kernel == "block_kernel":
            r["block_launches_expected"] = r["camera_launches_expected"]
            ok = ok and [launches_t, launches_u] == [
                {kernel: k, CAMERA: k} for k in r["block_launches_expected"]]
        else:
            # one bounce_kernel launch after each walk
            limit = cfg.samples_per_frame * cfg.max_bounces
            # each a sorted query (sort_key_kernel once)
            ok = (ok and set(launches_t) == set(launches_u)
                  == {kernel, "sort_key_kernel", "bounce_kernel", CAMERA}
                  and 0 < launches_t[kernel] <= len(mesh) * limit
                  and 0 < launches_u[kernel] <= limit
                  and all(n["bounce_kernel"] == n[kernel]
                          == n["sort_key_kernel"]
                          for n in (launches_t, launches_u)))
        check(ok and r["finite"] and r["elements_equal"] >= 0.999
              and r["queries_tiled"] == q_u + q_pad,
              f"dist: tiled against untiled {r}")
        return r, img_u

    mesh4 = dmesh.make_mesh(devices=["cuda:0"] * 4)
    rec["hero_tiled"], hero_img = tiled_vs_untiled(
        sc5, info5, hero_cfg, cam5, mesh4, "block_kernel")
    rec["terrain_1m_tiled"], _ = tiled_vs_untiled(
        c.big, c.big_info, c.RenderConfig(
            width=800, height=600, samples_per_frame=BIG_SPP,
            max_bounces=BIG_BOUNCES, auto_focus=False, blur=0.0),
        c.big_cam, mesh4, "streamed_kernel")

    # the sample split on config 2, and its golden
    sc2, info2 = c.scenes.BUILDERS[2]().build(device="cuda")
    cam2 = c.scenes.CAMERAS[2]
    mesh2 = dmesh.make_mesh(devices=["cuda:0"] * 2)
    cfg2 = c.RenderConfig(width=800, height=600, samples_per_frame=16,
                          max_bounces=BOUNCES)
    c.zero_counts()
    split, q_split = dmesh.render_frame_sample_split(
        sc2, info2, cfg2, cam2[0], cam2[1], DIST_SEED, mesh2)
    torch.cuda.synchronize()
    launches = c.counts()
    a, qa = untiled(sc2, info2, cfg2, cam2, DIST_SEED)
    b, qb = untiled(sc2, info2, cfg2, cam2, dmesh.split_seed(DIST_SEED, 1))
    gw, gh, gspp, gseed = GOLDEN
    gcfg = c.RenderConfig(width=gw, height=gh, samples_per_frame=gspp // 2,
                          max_bounces=BOUNCES, auto_focus=False, blur=0.0)
    golden_img, _ = dmesh.render_frame_sample_split(
        sc2, info2, gcfg, cam2[0], cam2[1], gseed, mesh2)
    golden = c.img_util.read_png(os.path.join(ROOT, "tests", "goldens",
                                              "config2.png"))
    rec["sample_split"] = {
        "shape": [800, 600, 16, BOUNCES], "mesh": [str(d) for d in mesh2],
        "seeds": [DIST_SEED, dmesh.split_seed(DIST_SEED, 1)],
        "equal_to_mean": bool(torch.equal(split, (a + b) / 2.0)),
        "queries": int(q_split), "queries_of_the_two": qa + qb,
        "launches": launches,
        "golden_rmse": c.img_util.rmse(
            np.clip(golden_img.cpu().numpy(), 0.0, 1.0), golden),
        "golden_shape": [gw, gh, gspp // 2, 2]}
    check(rec["sample_split"]["equal_to_mean"]
          and int(q_split) == qa + qb
          and launches == {"block_kernel": 2 * 16, CAMERA: 2 * 16}
          and rec["sample_split"]["golden_rmse"] < 0.05,
          f"dist: sample split {rec['sample_split']}")

    # DistributedRenderer: the hero over [cuda:0] * 4
    dr = dmesh.DistributedRenderer(sc5, info5, hero_cfg, mesh4,
                                   cam_pos=cam5[0], cam_rot=cam5[1], seed=5)
    dr.step()
    torch.cuda.synchronize()
    c.zero_counts()
    q0, walls, events = dr.rays_traced, [], []
    for _ in range(2):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        e0.record()
        dr.step()
        e1.record()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
        events.append(e0.elapsed_time(e1))
    launches = c.counts()
    queries = dr.rays_traced - q0
    path = os.path.join(tmp, "dist.npz")
    dr.save_checkpoint(path)
    resumed = dmesh.DistributedRenderer(sc5, info5, hero_cfg, mesh4,
                                        cam_pos=cam5[0], cam_rot=cam5[1],
                                        seed=5)
    resumed.load_checkpoint(path)
    loaded_equal = bool(torch.equal(dr.display_image(),
                                    resumed.display_image()))
    step_equal = bool(torch.equal(dr.step(), resumed.step()))
    dr.move_camera(pos=(cam5[0][0], cam5[0][1] + 0.1, cam5[0][2]))
    hero = session_rec["hero"]
    rec["renderer"] = {
        "shape": [1920, 1080, 8, 6], "mesh": [str(d) for d in mesh4],
        "wall_ms": walls, "cuda_ms": events, "queries": queries,
        "mrays_per_s": queries / (sum(walls) / 1e3) / 1e6,
        "session_hero_mrays_per_s": hero["mrays_per_s"],
        "session_hero_frame_ms": 1e3 * hero["frame_s"],
        "launches": launches, "loaded_equal": loaded_equal,
        "step_equal": step_equal, "seed_draws": resumed._seed_draws,
        "count_after_move": dr._count}
    check(launches == {"block_kernel": 2 * 4 * 8, CAMERA: 2 * 4 * 8}
          and loaded_equal
          and step_equal and resumed._seed_draws == 4
          and dr._count == 0
          and float(dr.display_image().abs().max()) == 0.0,
          f"dist: DistributedRenderer {rec['renderer']}")
    # where a frame's time goes: the card's busy share, block_kernel's part
    rec["renderer"]["profile"] = trace_busy(dr.step)
    rec["renderer"]["busy_share"] = rec["renderer"]["profile"]["busy_share"]
    del dr, resumed

    # two processes on the card, joined over gloo
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    ctx = mp.start_processes(dist_worker,
                             args=(f"127.0.0.1:{port}", 2, tmp), nprocs=2,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + DIST_TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            check(time.monotonic() < deadline,
                  f"dist: the two processes ran past {DIST_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    ranks = []
    for rank in range(2):
        with open(os.path.join(tmp, f"rank{rank}.json")) as f:
            ranks.append(json.load(f))
    assembled = torch.from_numpy(np.load(os.path.join(tmp, "assembled.npy")))
    rec["two_processes"] = {
        "backend": "gloo", "seconds": time.perf_counter() - t0,
        "ranks": ranks, "elements_equal": float(
            (assembled.to(dev) == hero_img).float().mean())}
    check([r["rows"] for r in ranks] == [[0, 540], [540, 1080]]
          and all(r["launches"]["block_kernel"] > 0 for r in ranks)
          and rec["two_processes"]["elements_equal"] >= 0.999,
          f"dist: two processes {rec['two_processes']}")

    # a mesh of two cards, where there are two
    if torch.cuda.device_count() > 1:
        rec["multi_card"], _ = tiled_vs_untiled(
            sc5, info5, hero_cfg, cam5,
            dmesh.make_mesh(devices=["cuda:0", "cuda:1"]), "block_kernel")
    else:
        rec["multi_card"] = "not run: 1 card"
    shutil.rmtree(tmp, ignore_errors=True)
    rec["seconds"] = time.perf_counter() - t_start
    emit(rec, c.log)
    return rec


# phase `tools`: configs the profile twin times, the terrains of the scale
# tools, and the frame whose peak memory the 4M terrain is read after (the
# scale frame's settings)
TOOLS_PROFILE_CONFIGS = (1, 2, 3, 4, 6)
TOOLS_TRACE_CONFIG = 3
TOOLS_STREAMED_N, TOOLS_BUILD_N = 708, 1416


def tools_phase(c, session_rec):
    """Phase 10, `tools`: the port's run tools (pathtracer0_tpu_torch/tools)
    at their full defaults, through their own entry points, each with the
    launch counts set to 0 just before it and read just after. profile:
    configs 1, 2, 3, 4, 6 at BENCH_PARAMS (spp capped at 8), its five rows
    each; the full frame and fused=on launch frame_kernel once a frame,
    fused=off never; --trace on config 3: the trace file, the card's busy
    share, frame_kernel among the traced kernels. diag_streamed at n = 708:
    the four populations of 262,144 rays, each batch as the tool hands it
    to streamed_kernel held against streamed_reference at the
    streamed-parity limits, with the kernel's device ms and bound as phase
    2 computes them (`compare_streamed`). diag_scale_frame at n = 708: its
    six settings; at each spp the live queries rise with the bounces.
    diag_build4m at n = 1416: build s, each large table's put MB/s, the
    total bytes; the peak allocated memory of the build and of one
    800x600, 2 spp, 3-bounce path frame of the 4M terrain
    (torch.cuda.max_memory_allocated after reset_peak_memory_stats, and
    above what earlier phases hold). run_hero_full to 4,096 spp into a
    temporary directory: no watchdog anomaly, 512 frames, the residual
    noise finite, frame_kernel launched once a frame; its time to 4,096
    spp beside phase `session`'s estimate."""
    torch, np = c.torch, c.np
    from pathtracer0_tpu_torch.kernels import frame, wavefront
    from pathtracer0_tpu_torch.render.renderer import render_frame
    from pathtracer0_tpu_torch.tools import (diag_build4m, diag_scale_frame,
                                             diag_streamed, profile,
                                             run_hero_full)

    t_start = time.perf_counter()
    rec = {"phase": "tools", "card": c.card}
    tmp = tempfile.mkdtemp()

    def quiet(*_):
        pass

    # profile: five rows a config
    rec["profile"] = {}
    for n in TOOLS_PROFILE_CONFIGS:
        argv = ["--config", str(n)]
        if n == TOOLS_TRACE_CONFIG:
            argv += ["--trace", os.path.join(tmp, "trace")]
        c.zero_counts()
        t0 = time.perf_counter()
        out = profile.main(argv, out=quiet)
        rows = {r["row"]: r for r in out["rows"]}
        cell = {"seconds": time.perf_counter() - t0,
                "rows": {name: {k: r[k] for k in (
                    "ms", "mrays_per_s_nominal", "launches_per_frame")}
                    for name, r in rows.items()},
                "launches": c.counts()}
        rec["profile"][n] = cell
        for name in ("full frame", "fused=on"):
            check(rows[name]["launches_per_frame"].get("frame_kernel") == 1,
                  f"tools: profile config {n} {name}: {cell}")
        check("frame_kernel" not in rows["fused=off (per-bounce path)"][
                  "launches_per_frame"]
              and all(r["ms"] > 0 for r in rows.values()),
              f"tools: profile config {n}: {cell}")
        if out["trace"] is not None:
            busy = out["trace"]
            cell["trace"] = {k: busy[k] for k in (
                "trace", "busy_share", "wall_ms_untraced", "device_busy_ms",
                "device_kernels", "ours", "top")}
            cell["trace"]["trace_bytes"] = os.path.getsize(busy["trace"])
            check(cell["trace"]["trace_bytes"] > 0
                  and busy["busy_share"] is not None
                  and busy["busy_share"] > 0
                  and any("frame_kernel" in k["name"] for k in busy["ours"]),
                  f"tools: profile --trace {cell['trace']}")

    # diag_streamed: the tool's populations, each checked against the plain
    # walk on the card
    sc, info = diag_streamed.terrain(TOOLS_STREAMED_N)
    c.zero_counts()
    t0 = time.perf_counter()
    runs = diag_streamed.main(TOOLS_STREAMED_N, scene=(sc, info), out=quiet)
    seconds = time.perf_counter() - t0
    launches = c.counts()
    check(launches == {"streamed_kernel": 4 * len(runs)},
          f"tools: diag_streamed launches {launches}")
    rec["diag_streamed"] = {"seconds": seconds, "tris": info.num_tris,
                            "treelets": info.st_n_treelets,
                            "launches": launches, "populations": {}}
    for row, (o, d, t_init, _, _) in runs:
        parity = c.compare_streamed(f"diag_streamed {row['label']}", sc, info,
                                    o, d, t_init)
        rec["diag_streamed"]["populations"][row["label"]] = {
            **{k: row[k] for k in ("box_tests_per_ray", "row_visits_per_ray",
                                   "pairs_per_ray", "ms", "mrays_per_s",
                                   "hit_pct")},
            **{f"kernel_{k}": parity[k] for k in (
                "ms", "wrapper_ms", "plain_ms", "bound_ms", "bound_by",
                "idx_eq", "max_abs_err", "box_eq", "rows_eq")}}
    del sc, info, runs

    # diag_scale_frame: queries rise with the bounces
    c.zero_counts()
    t0 = time.perf_counter()
    rows = diag_scale_frame.main(TOOLS_STREAMED_N, out=quiet)
    rec["diag_scale_frame"] = {"seconds": time.perf_counter() - t0,
                               "rows": rows, "launches": c.counts()}
    for spp in (1, 2):
        q = [r["live_queries"] for r in rows if r["spp"] == spp]
        check(len(q) == 3 and q[0] < q[1] < q[2]
              and q[0] == 800 * 600 * spp,
              f"tools: diag_scale_frame spp {spp}: {rows}")
    check(set(rec["diag_scale_frame"]["launches"])
          == {"streamed_kernel", "sort_key_kernel", "bounce_kernel", CAMERA},
          f"tools: diag_scale_frame {rec['diag_scale_frame']['launches']}")

    # diag_build4m and the 4M terrain's peak memory
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    c.zero_counts()
    t0 = time.perf_counter()
    build, sc4, info4 = diag_build4m.main(TOOLS_BUILD_N, out=quiet)
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    mem = {"held_before_bytes": held,
           "build_peak_bytes": torch.cuda.max_memory_allocated(),
           "scene_bytes": torch.cuda.memory_allocated() - held}
    torch.cuda.reset_peak_memory_stats()
    cfg = c.RenderConfig(width=800, height=600, samples_per_frame=2,
                         max_bounces=3, auto_focus=False, blur=0.0)
    cam = diag_scale_frame.camera(TOOLS_BUILD_N)
    img, q = render_frame(sc4, info4, cfg, *cam, 1234, device="cuda")
    torch.cuda.synchronize()
    mem["frame_peak_bytes"] = torch.cuda.max_memory_allocated()
    for k in ("build", "frame"):
        mem[f"{k}_peak_above_held_bytes"] = mem[f"{k}_peak_bytes"] - held
    rec["diag_build4m"] = {
        "seconds": seconds, **{k: build[k] for k in (
            "tris", "streamed", "build_s", "fields", "total_bytes",
            "total_mb")},
        "memory": mem, "frame_queries": int(q.sum()),
        "frame_finite": bool(torch.isfinite(img).all()),
        "launches": c.counts()}
    check(build["tris"] == 2 * (TOOLS_BUILD_N - 1) ** 2 and build["streamed"]
          and all(f["mb_per_s"] > 0 for f in build["fields"])
          and rec["diag_build4m"]["frame_finite"]
          and rec["diag_build4m"]["launches"].get("streamed_kernel", 0) > 0,
          f"tools: diag_build4m {rec['diag_build4m']}")
    del sc4, info4, img, q

    # run_hero_full: the hero to 4,096 spp
    lines = []
    c.zero_counts()
    t0 = time.perf_counter()
    hero = run_hero_full.run(out_dir=os.path.join(tmp, "hero"),
                             log=lines.append)
    rec["hero_run"] = {
        "seconds": time.perf_counter() - t0, **hero,
        "session_est_time_to_4096spp_s":
            session_rec["hero"]["est_time_to_4096spp_s"],
        "launches": c.counts(), "log": lines[:-1]}
    check(hero["frames"] == 512 and hero["checkpoints"] == 8
          and np.isfinite(hero["residual_noise_per_image"])
          and rec["hero_run"]["launches"] == {
              "frame_kernel": 16 + 2 * 512}
          and os.path.exists(os.path.join(tmp, "hero", "hero_ckpt_torch.npz")),
          f"tools: run_hero_full {rec['hero_run']}")
    shutil.rmtree(tmp, ignore_errors=True)
    rec["seconds"] = time.perf_counter() - t_start
    emit(rec, c.log)
    return rec


# phase `bounce`: the bytes of one bounce that bounce_kernel must move,
# counted from csrc/integrate.cuh `bounce_ray`, what the function needs and
# no more: every ray's alive flag; a live ray's origin and direction (24),
# the walk's t, u, v and row (16), its throughput (12) and its query count
# read and written (16); a ray that hit: the row's triangle id (4, where a
# permutation maps it), its radiance read and written (24), the next ray
# and throughput written (36), the stack size (8) and the RNG state (16)
# read and written, the medium flag (1), the stack's top two entries (8)
# and its alive flag (1); a ray that missed: its sky radiance read and
# written (24) and its alive flag (1); each triangle row hit once, its
# attributes and UVs (80); the material table and its map slots once. The
# Whitted form: every ray's flag and radiance (13), a live ray's origin,
# direction and walk (40), the rows and tables as above. Operations: the
# nudge and the hit location of a live ray (12); the shading depends on the
# data and is not counted, so the bound is a floor.
BOUNCE_LIVE_BYTES, BOUNCE_HIT_BYTES, BOUNCE_MISS_BYTES = 68, 94, 25
BOUNCE_ROW_BYTES, BOUNCE_PERM_BYTES, BOUNCE_LIVE_OPS = 80, 4, 12
WHITTED_RAY_BYTES, WHITTED_LIVE_BYTES = 13, 40
BOUNCE_REPS = 20
# the camera form of bounce_kernel in the launch counts
CAMERA = "bounce_kernel_camera"
# the bytes of the camera form a ray, counted from csrc/integrate.cuh
# `camera_ray`: the primary direction (12) and RNG state (8) read; the
# ray (24), the state (8) and the alive flag (1) written; the path state
# begun: throughput, radiance, sky radiance and entry point (48), the
# stack's bottom entry (4), its size (4) and the medium flag (1) written;
# the running total written (12): 122. The first sample also writes the
# query count (8): 130; a later one reads its sample's radiance and sky
# radiance (24) and the total (12) instead: 158. Operations: the focal
# point, the aim, its length and the division (21), with blur the jitter
# turned and added (21).
CAMERA_FIRST_BYTES, CAMERA_LATER_BYTES = 130, 158
CAMERA_OPS, CAMERA_BLUR_OPS = 21, 21
# the stack depths past the frame and block kernels' 16 that phase `bounce`
# renders through Renderer
DEEP_STACKS = (17, 32)


def bounce_phase(c, trees):
    """Phase 11, `bounce`: bounce_kernel (csrc/bounce_kernel.cu), one launch
    a bounce of the per-bounce route.

    Kernel against plain version on one sample's 800x600 rays of each
    cell's camera: the terrain (traverse_kernel), the OBJ grid
    (brute_kernel), the 1M terrain (streamed_kernel, 3 bounces), configs 4
    (no tree: implicits, ellipsoids, subsurface) and 6 (maps, a normal
    map; brute_kernel). The path form bounce after bounce as the route
    takes them: from the same state and walk, `bounce_step` and
    `bounce_step_plain` on two copies, at the kernel-parity limits over the
    rays alive at the bounce (RNG state bit-equal on >= 99%, radiance
    within 1e-4 on >= 99%, queries equal, one launch, the rays left alive
    within 1% of the plain version's); the route goes on from the kernel's
    state. At each bounce the kernel's time (BOUNCE_REPS launches on as
    many copies of the state between CUDA events), its wrapper's, the
    plain version's, and the bound. The Whitted form on the
    same rays (one in seven switched off: radiance 0 there), and the
    locate form with the thickness probe on the OBJ grid with a subsurface
    material.

    Frames: each cell through Renderer at 800x600 (the terrain path and
    Whitted, the OBJ grid and configs 4 and 6 with fused="off" at 8 spp,
    the 1M terrain at 2 spp and 3 bounces), this checkout's and each
    --parent's: wall and CUDA ms of 2 timed frames after a warm-up, the
    launches a frame by kernel, and one frame under torch.profiler
    (tools/profile.trace_busy): the card's busy share and its device
    operations, per bounce of the frame (this checkout's bounce_kernel
    launches a frame)."""
    import importlib

    torch, np, dev, scenes = c.torch, c.np, c.dev, c.scenes
    from pathtracer0_tpu_torch.kernels import bounce, traverse
    from pathtracer0_tpu_torch.render import integrator
    from pathtracer0_tpu_torch.tools import bounce_turns
    from pathtracer0_tpu_torch.tools.profile import trace_busy

    t_start = time.perf_counter()
    rec = {"phase": "bounce", "card": c.card, "path": {}, "loop": {},
           "whitted": {}, "frames": {}}
    built = {
        "terrain": (c.terrain, c.terrain_info, c.terrain_cam, BOUNCES),
        "obj_grid": (c.grid, c.grid_info, c.grid_cam, BOUNCES),
        "terrain_1m": (c.big, c.big_info, c.big_cam, BIG_BOUNCES)}
    for n in (4, 6):
        built[f"config{n}"] = (*scenes.BUILDERS[n]().build(device=dev),
                               scenes.CAMERAS[n], BOUNCES)
    # the OBJ grid's material 0 with subsurface: the Whitted form's probe
    mats = c.grid.materials.clone()
    mats[0, 41] = 0.7
    mats[0, 42:45] = torch.tensor([0.9, 0.5, 0.3])
    mats[0, 45:48] = torch.tensor([0.8, 0.4, 0.3])
    ss_grid = (dataclasses.replace(c.grid, materials=mats),
               c.grid_info._replace(
                   mat_gates=(True, *c.grid_info.mat_gates[1:])))
    check(not traverse.has_tree(built["config4"][1])
          and traverse.has_tree(built["config6"][1])
          and c.wavefront.use_brute(built["config6"][1]),
          "bounce: configs 4 and 6 are not the scenes described")

    def share(ok, among):
        return float(ok[among].float().mean())

    def tables(sc):
        return sum(t.numel() * t.element_size()
                   for t in (sc.materials, sc.mat_maps))

    def hits_of(sc, info, st, walk):
        """(rays that hit, distinct triangle rows hit) among the live."""
        on = traverse.nudged(tuple(st.o), tuple(st.d))
        hit = traverse._merge_analytic_batched(
            on, tuple(st.d), sc, info, traverse.walk_hit(walk, sc))
        got = st.alive & hit.is_hit
        return int(got.sum()), int(torch.unique(
            hit.tri[got & (hit.kind == 1)]).numel())

    def kernel_ms(sc, info, st, walk, form, probe_t=None):
        """Device ms of one launch: BOUNCE_REPS launches back to back on as
        many copies of `st` (the path form writes its state in place)."""
        copies = [st.clone() for _ in range(BOUNCE_REPS + 1)]
        made = [bounce._args(sc, info, s, walk, form, probe_t)
                for s in copies]
        bounce.launch(made[0][0], dev)
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for args, _ in made[1:]:
            bounce.launch(args, dev)
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / BOUNCE_REPS

    def event_ms(fn):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b)

    # ---- the path form, bounce after bounce
    w, h = c.size
    mods = {"change": bounce, **{
        label: importlib.import_module(f"tree_{label}.kernels.bounce")
        for label in trees}}

    def path_cells(label, sc, info, cam, n_bounces, stack_size=10):
        """The path form against its plain version bounce after bounce on
        one sample's rays of the cell (and in turns against each --parent
        tree's kernel); returns the cells of the bounces."""
        o, d, state = c.sample_rays(*cam, w, h)
        n = state.shape[0]
        alive = torch.ones(n, dtype=torch.bool, device=dev)
        st = bounce.begin(o, d, alive, state, stack_size=stack_size)
        cells = []
        for k in range(n_bounces):
            live = st.alive.clone()
            n_live = int(live.sum())
            if not n_live:
                break
            walk = traverse.walk_triangles(tuple(st.o), tuple(st.d), sc,
                                           info, active=st.alive)[0]
            n_hit, n_rows = hits_of(sc, info, st, walk)
            ms = kernel_ms(sc, info, st, walk, "path")
            kern, plain = st.clone(), st.clone()
            before = bounce.bounce_step.launches
            wrapper_ms = event_ms(
                lambda: bounce.bounce_step(sc, info, kern, walk))
            launched = bounce.bounce_step.launches - before
            plain_ms = event_ms(
                lambda: bounce.bounce_step_plain(sc, info, plain, walk))
            rad_k, rad_p = kern.inc + kern.skyc, plain.inc + plain.skyc
            diff = (rad_k - rad_p).abs().amax(0)[live]
            nbytes = (n + n_live * BOUNCE_LIVE_BYTES
                      + n_hit * (BOUNCE_HIT_BYTES + BOUNCE_PERM_BYTES
                                 * (walk.perm is not None))
                      + (n_live - n_hit) * BOUNCE_MISS_BYTES
                      + n_rows * BOUNCE_ROW_BYTES + tables(sc))
            cell = {"bounce": k, "rays": n, "alive": n_live, "hits": n_hit,
                    "rows_hit": n_rows,
                    "state_eq": share(kern.state == plain.state, live),
                    "alive_eq": share(kern.alive == plain.alive, live),
                    "frac_within_1e-4": float((diff < 1e-4).float().mean()),
                    "max_abs_err": float(diff.max()),
                    "queries_equal": bool(torch.equal(kern.queries,
                                                      plain.queries)),
                    "left_alive": [int(kern.alive.sum()),
                                   int(plain.alive.sum())],
                    "launches": launched, "ms": ms, "wrapper_ms": wrapper_ms,
                    "plain_ms": plain_ms,
                    **c.least(nbytes, n_live * BOUNCE_LIVE_OPS)}
            if trees:
                cell["turns"] = bounce_turns.turns(
                    sc, info, st, walk, "path", mods, reps=BOUNCE_REPS)
                check(all(x["bits_equal"] for x in cell["turns"].values()),
                      f"bounce: path form, {label} bounce {k}: the trees' "
                      f"kernels against this one {cell['turns']}")
            cells.append(cell)
            check(cell["state_eq"] >= 0.99 and cell["frac_within_1e-4"] >= 0.99
                  and cell["queries_equal"] and launched == 1
                  and cell["ms"] >= cell["bound_ms"]
                  and abs(cell["left_alive"][0] - cell["left_alive"][1])
                  <= 0.01 * cell["left_alive"][1] + 16
                  and bool(torch.isfinite(rad_k).all()),
                  f"bounce: path form, {label} bounce {k}: {cell}")
            st = kern
        return cells, (o, d, alive, state)

    for label, (sc, info, cam, n_bounces) in built.items():
        cells, (o, d, alive, state) = path_cells(label, sc, info, cam,
                                                 n_bounces)
        rec["path"][label] = cells
        check(len(cells) >= 2 and cells[0]["hits"] > 0,
              f"bounce: {label}: {cells}")
        # the device operations of one bounce of the route's loop: one
        # traced trace_bounces call on the same rays at 1 bounce and at
        # all of them; the difference over the bounces between
        traces = {nb: trace_busy(lambda nb=nb: integrator.trace_bounces(
                      sc, info, o, d, alive, state, max_bounces=nb),
                      device=dev) for nb in (1, n_bounces)}
        ops = {nb: tr["device_kernels"] for nb, tr in traces.items()}
        loop = {"device_ops_1_bounce": ops[1],
                f"device_ops_{n_bounces}_bounces": ops[n_bounces],
                "bounces": len(cells),
                "lead_kept": [tr["lead_kept"] for tr in traces.values()],
                "trace_tries": [tr["trace_tries"] for tr in traces.values()]}
        if ops[1] is not None:
            loop["device_ops_per_bounce"] = (
                (ops[n_bounces] - ops[1]) / (n_bounces - 1))
            # eager shading took 757-950 a bounce; the walk and the bounce
            # kernel ~10, the streamed sort ~50 more
            check(0 < loop["device_ops_per_bounce"] < 100,
                  f"bounce: {label}: device operations a bounce {loop}")
        rec["loop"][label] = loop

    # ---- the Whitted form, and the locate form with the probe
    whitted_scenes = dict(built, obj_grid_subsurface=(*ss_grid, c.grid_cam,
                                                      1))
    for label, (sc, info, cam, _) in whitted_scenes.items():
        o, d, _ = c.sample_rays(*cam, w, h)
        n = o[0].shape[0]
        alive = torch.arange(n, device=dev) % 7 != 0
        n_live = int(alive.sum())
        walk = traverse.walk_triangles(o, d, sc, info, active=alive)[0]
        probing = bool(info.mat_gates[0]) and traverse.has_tree(info)
        kern = bounce.begin_whitted(o, d, alive, probe=probing)
        plain = bounce.begin_whitted(o, d, alive, probe=probing)
        cell, probe_t = {"rays": n, "alive": n_live, "probe": probing}, None
        if probing:
            bounce.bounce_step(sc, info, kern, walk, form="locate")
            bounce.bounce_step_plain(sc, info, plain, walk, form="locate")
            cell["loc_eq"] = share((kern.loc == plain.loc).all(0), alive)
            cell["locate_ms"] = kernel_ms(sc, info, kern, walk, "locate")
            probe_t = traverse.probe_forest_t(tuple(kern.loc), d, sc, info)
            check(cell["loc_eq"] >= 0.99, f"bounce: locate {label}: {cell}")
        before = bounce.bounce_step.launches
        bounce.bounce_step(sc, info, kern, walk, form="whitted",
                           probe_t=probe_t)
        launched = bounce.bounce_step.launches - before
        plain_ms = event_ms(lambda: bounce.bounce_step_plain(
            sc, info, plain, walk, form="whitted", probe_t=probe_t))
        diff = (kern.inc - plain.inc).abs().amax(0)
        st_hits = bounce.BounceState(o=kern.o, d=kern.d, alive=alive,
                                     inc=kern.inc)
        n_hit, n_rows = hits_of(sc, info, st_hits, walk)
        nbytes = (n * WHITTED_RAY_BYTES + n_live * WHITTED_LIVE_BYTES
                  + n_hit * BOUNCE_PERM_BYTES * (walk.perm is not None)
                  + n_rows * BOUNCE_ROW_BYTES + tables(sc))
        cell.update({
            "hits": n_hit, "rows_hit": n_rows,
            "frac_within_1e-4": share(diff < 1e-4, alive),
            "max_abs_err": float(diff[alive].max()),
            "off_rays_zero": bool((kern.inc[:, ~alive] == 0).all()),
            "launches": launched,
            "ms": kernel_ms(sc, info, kern, walk, "whitted", probe_t),
            "plain_ms": plain_ms, **c.least(nbytes, n_live * BOUNCE_LIVE_OPS)})
        if trees:
            fresh = bounce.begin_whitted(o, d, alive, probe=probing)
            cell["turns"] = {"whitted": bounce_turns.turns(
                sc, info, fresh, walk, "whitted", mods, probe_t,
                reps=BOUNCE_REPS)}
            if probing:
                cell["turns"]["locate"] = bounce_turns.turns(
                    sc, info, fresh, walk, "locate", mods, reps=BOUNCE_REPS)
            check(all(x["bits_equal"] for t in cell["turns"].values()
                      for x in t.values()),
                  f"bounce: Whitted forms, {label}: the trees' kernels "
                  f"against this one {cell['turns']}")
        rec["whitted"][label] = cell
        check(cell["frac_within_1e-4"] >= 0.99 and cell["off_rays_zero"]
              and launched == 1 and bool(torch.isfinite(kern.inc).all())
              and cell["ms"] >= cell["bound_ms"],
              f"bounce: Whitted form, {label}: {cell}")

    # ---- the camera form against its plain version, each cell's camera
    rec["camera"] = {}
    for label, (sc, info, cam, _) in built.items():
        uv, index = c.camera.pixel_centers(w, h, dev)
        pos, rot = (torch.tensor(v, dtype=torch.float32, device=dev)
                    for v in cam)
        rotmat = c.vm.rotation_matrix(rot)
        pd = c.camera.primary_directions(uv, rotmat, 1.5, 1.0,
                                         h / w).T.contiguous()
        cams = bounce.camera_scalars(pos, rotmat,
                                     torch.tensor(20.0, device=dev))
        n = index.shape[0]
        for blur in (0.0, HERO["blur"]):
            sts = {}
            for who, step in (("kernel", bounce.camera_step),
                              ("plain", bounce.camera_step_plain)):
                st = bounce.state_for(c.vrng.seed(index, 77), path=True,
                                      totals=True)
                g = torch.Generator(device=dev).manual_seed(5)
                step(st, pd, cams, blur)
                # the sample's radiance, then the next sample adds it
                st.inc.copy_(torch.rand(st.inc.shape, generator=g,
                                        device=dev))
                st.skyc.copy_(torch.rand(st.skyc.shape, generator=g,
                                         device=dev))
                step(st, pd, cams, blur, accumulate=True)
                sts[who] = st
            kern, plain = sts["kernel"], sts["plain"]
            fields = ("state", "alive", "col", "inc", "skyc", "enter",
                      "ssize", "inobj", "queries", "total")
            ray_eq = {f: float((getattr(kern, f) == getattr(plain, f))
                               .all(0).float().mean()) for f in ("o", "d")}
            ray_err = max(float((getattr(kern, f) - getattr(plain, f))
                                .abs().max()) for f in ("o", "d"))
            state_equal = {f: bool(torch.equal(getattr(kern, f),
                                               getattr(plain, f)))
                           for f in fields}
            bottom_equal = bool(torch.equal(kern.stack[0], plain.stack[0]))
            # the timed launches advance the states: compared first
            ms = {acc: bounce_turns.camera_ms(kern, pd, cams, blur, acc,
                                              BOUNCE_REPS)
                  for acc in (False, True)}
            plain_ms = event_ms(lambda: bounce.camera_step_plain(
                plain, pd, cams, blur, accumulate=True))
            ops = n * (CAMERA_OPS + CAMERA_BLUR_OPS * (blur != 0.0))
            cell = {
                "rays": n, "blur": blur, "state_equal": state_equal,
                "stack_bottom_equal": bottom_equal,
                "rays_equal_share": ray_eq, "max_abs_err": ray_err,
                "ms_first": ms[False], "ms": ms[True], "plain_ms": plain_ms,
                "first": c.least(n * CAMERA_FIRST_BYTES, ops),
                **c.least(n * CAMERA_LATER_BYTES, ops)}
            rec["camera"][f"{label} blur {blur}"] = cell
            exact = blur == 0.0
            check(all(cell["state_equal"].values())
                  and cell["stack_bottom_equal"]
                  and min(ray_eq.values()) >= (1.0 if exact else 0.999)
                  and ray_err <= (0.0 if exact else 1e-6)
                  and ms[True] >= cell["bound_ms"]
                  and ms[False] >= cell["first"]["bound_ms"],
                  f"bounce: camera form, {label} blur {blur}: {cell}")

    # ---- stacks deeper than the frame and block kernels' 16: the path
    # form against its plain version, and frames through Renderer
    rec["deep_stacks"] = {}
    config2 = (*scenes.BUILDERS[2]().build(device=dev), scenes.CAMERAS[2])
    deep_cells = {"terrain": (c.terrain, c.terrain_info, c.terrain_cam),
                  "config2": config2}
    check(c.frame.eligible(config2[1], stack_size=16)
          and not c.frame.eligible(config2[1], stack_size=17),
          "bounce: config 2 must leave the frame path past a stack of 16")
    for depth in DEEP_STACKS:
        for label, (sc, info, cam) in deep_cells.items():
            cells, _ = path_cells(f"{label} stack {depth}", sc, info, cam,
                                  BOUNCES, stack_size=depth)
            cfg = c.RenderConfig(width=w, height=h, samples_per_frame=2,
                                 max_bounces=BOUNCES, auto_focus=True,
                                 refraction_stack_depth=depth)
            r = c.Renderer(sc, info, cfg, cam_pos=cam[0], cam_rot=cam[1],
                           seed=9, device=dev)
            c.zero_counts()
            img = r.step()
            torch.cuda.synchronize()
            launches = c.counts()
            cell = {"path": cells, "launches": launches,
                    "finite": bool(torch.isfinite(img).all()),
                    "picture_std": float(img.clamp(0.0, 1.0).std())}
            rec["deep_stacks"][f"{label} {depth}"] = cell
            check(cell["finite"] and cell["picture_std"] > 0.02
                  and "frame_kernel" not in launches
                  and "block_kernel" not in launches
                  and launches.get(CAMERA) == 2
                  and launches.get("bounce_kernel", 0) > 0,
                  f"bounce: {label} at a stack of {depth}: {cell}")

    # ---- frames, this checkout's and each other checkout's
    frame_cells = (
        ("terrain_path", "terrain", dict(samples_per_frame=TERRAIN_SPP,
                                         max_bounces=BOUNCES,
                                         auto_focus=True)),
        ("terrain_whitted", "terrain", dict(samples_per_frame=TERRAIN_SPP,
                                            max_bounces=BOUNCES,
                                            raytracing=False,
                                            auto_focus=True)),
        ("obj_grid_off", "obj_grid", dict(fused="off",
                                          samples_per_frame=TERRAIN_SPP,
                                          max_bounces=BOUNCES,
                                          auto_focus=False,
                                          focal_distance=5.0)),
        ("terrain_1m_path", "terrain_1m", dict(samples_per_frame=BIG_SPP,
                                               max_bounces=BIG_BOUNCES,
                                               auto_focus=False, blur=0.0)),
        ("config4_off", "config4", dict(fused="off", samples_per_frame=8,
                                        max_bounces=BOUNCES,
                                        auto_focus=True)),
        ("config6_off", "config6", dict(fused="off", samples_per_frame=8,
                                        max_bounces=BOUNCES,
                                        auto_focus=True)))
    packages = {"change": (c.Renderer, c.RenderConfig, None)}
    for label, tree in trees.items():
        mod = sys.modules[f"tree_{label}"]
        packages[label] = (mod.Renderer, mod.RenderConfig, tree["wavefront"])
    real_dof_ray = c.camera.dof_ray

    def no_dof_ray(*args, **kwargs):
        raise CheckFailed("bounce: camera.dof_ray ran on the card's route")

    for name, scene, kw in frame_cells:
        sc, info, cam, _ = built[scene]
        cell = {}
        for who, (Renderer, RenderConfig, their_walks) in packages.items():
            r = Renderer(sc, info, RenderConfig(width=w, height=h, **kw),
                         cam_pos=cam[0], cam_rot=cam[1], seed=9, device=dev)
            r.step()
            torch.cuda.synchronize()
            c.zero_counts()
            walks0 = dict(their_walks.launches) if their_walks else None
            if their_walks is None:
                # this checkout's route makes its rays in the camera form
                c.camera.dof_ray = no_dof_ray
            try:
                walls, events, queries = c.timed_frames(r, 2)
                if their_walks is None:
                    launches = {k: v / 3 for k, v in c.counts().items()}
                else:
                    launches = {k: (v - walks0[k]) / 3
                                for k, v in their_walks.launches.items()
                                if v != walks0[k]}
                busy = trace_busy(r.step)
            finally:
                c.camera.dof_ray = real_dof_ray
            cell[who] = {
                "wall_ms": walls, "cuda_ms": events, "queries": queries,
                "mrays_per_s": queries / (sum(walls) / 1e3) / 1e6,
                "launches_per_frame": launches,
                **{k: busy[k] for k in ("busy_share", "device_busy_ms",
                                        "device_kernels", "wall_ms_untraced",
                                        "ours")}}
        bounces = cell["change"]["launches_per_frame"].get("bounce_kernel",
                                                           0)
        for who in cell:
            cell[who]["bounces_per_frame"] = bounces
            cell[who]["device_ops_per_bounce"] = (
                cell[who]["device_kernels"] / bounces if bounces else None)
        rec["frames"][name] = cell
        # one camera form launch a sample of this checkout's frames
        check(bounces > 0 and all(
            x["launches_per_frame"].get("frame_kernel", 0) == 0
            and x["launches_per_frame"].get("block_kernel", 0) == 0
            for x in cell.values())
            and cell["change"]["launches_per_frame"].get(CAMERA)
            == kw["samples_per_frame"], f"bounce: frames {name}: {cell}")
    rec["seconds"] = time.perf_counter() - t_start
    emit(rec, c.log)
    return rec


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np

    from pathtracer0_tpu_torch import RenderConfig, Renderer, Scene, scenes
    from pathtracer0_tpu_torch.core import camera
    from pathtracer0_tpu_torch.core import math as vm
    from pathtracer0_tpu_torch.core import rng as vrng
    from pathtracer0_tpu_torch.accel import lbvh
    from pathtracer0_tpu_torch.kernels import (bounce, build, frame, fused,
                                               mm_probe, mxu_group, mxu_tri,
                                               traverse, wavefront)
    from pathtracer0_tpu_torch.render import integrator
    from pathtracer0_tpu_torch.render.renderer import (autofocus_distance,
                                                       render_frame,
                                                       render_rays)
    from pathtracer0_tpu_torch.tools import diag_mxu, diag_mxu_mm
    from pathtracer0_tpu_torch.utils import image as img_util

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log = []
    card = smi()
    print(card, flush=True)
    name = torch.cuda.get_device_name(0)
    peaks = set_peaks(
        torch.cuda.get_device_properties(0).multi_processor_count)
    dev = torch.device("cuda")

    # ---- 1. environment + build --------------------------------------------
    from concurrent.futures import ThreadPoolExecutor

    trees = {label: load_tree(label, path)
             for label, path in parent_trees().items()}
    t0 = time.perf_counter()
    capped = os.path.join(tempfile.mkdtemp(), "frame_cap128.so")

    def build_capped():
        """With other checkouts to compare: frame_kernel.cu once more under
        -maxrregcount=128, for the registers and spills ptxas then picks."""
        out = subprocess.run(
            [build.nvcc(), *build.FLAGS, "-maxrregcount=128", "-o", capped,
             str(build.CSRC / "frame_kernel.cu")], capture_output=True,
            text=True, check=True)
        return ptxas_usage(out.stdout + out.stderr)

    with ThreadPoolExecutor() as pool:   # every compiler at once
        cap = pool.submit(build_capped) if trees else None
        # another checkout's frames of the per-bounce route (phase
        # `bounce`) walk through its forest and streamed kernels
        jobs = [pool.submit(build.build_all)] + [
            pool.submit(tree["build"].build_all,
                        sorted({lib for lib in COMPARED
                                if differs(tree, build, lib)}
                               | {"forest_kernel", "streamed_kernel"}))
            for tree in trees.values()]
        for job in jobs:
            job.result()
    ptxas = {lib: ptxas_usage(text) for lib, text in build.ptxas_log.items()}
    emit({"phase": "environment", "card": card, "device": name,
          "peaks": peaks, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "build_s": round(time.perf_counter() - t0, 3), "ptxas": ptxas,
          "sass": {lib: sass_counts(build, lib)
                   for lib in (*COMPARED, "bounce_kernel")},
          "frame_kernel_maxrregcount_128": cap.result() if cap else None,
          "parents": {label: {lib: {"ptxas": ptxas_usage(text),
                                    "sass": sass_counts(tree["build"], lib)}
                              for lib, text in tree["build"].ptxas_log.items()}
                      for label, tree in trees.items()}},
         log)

    def cuda_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    def device_ms(fn, key, reps=20, lib_of=build):
        """The device time of one launch of kernel `key`, which one call of
        fn launches once through `lib_of` (this package's kernels/build.py
        or another checkout's): the call's launch runs once, then `reps`
        times more back to back between two CUDA events (KernelRepeat), so
        the wrapper's host time is not in it."""
        lib_name, launcher = LAUNCHERS[key]
        real = lib_of.load(lib_name)
        fn()
        torch.cuda.synchronize()
        repeat = KernelRepeat(torch, real, launcher, reps)
        lib_of._libs[lib_name] = repeat
        try:
            fn()
        finally:
            lib_of._libs[lib_name] = real
        check(repeat.ms is not None, f"{key}: the call launched no kernel")
        return repeat.ms

    def table_bytes(sc, names):
        return sum(getattr(sc, k).numel() * getattr(sc, k).element_size()
                   for k in names)

    def least(nbytes, ops, **more):
        t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK["f32"]
        return {"bound_ms": 1e3 * max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes > t_ops else "operations",
                "bytes": nbytes, "ops_lower_bound": ops, **more}

    def bound(sc, info, n_rays, queries, ray_bytes=8 + 8 + 12):
        """Least time for the frame or block kernel: bytes (per pixel
        state in, state + radiance out; the block kernel also reads its
        rays and alive mask; the scene tables once) over the memory rate,
        or the float operations every query surely does over the float32
        rate, whichever is larger."""
        nbytes = n_rays * ray_bytes + table_bytes(sc, BRUTE_TABLES)
        n_rot = sum(info.ell_rotated) + sum(info.imp_rotated)
        ops = queries * (OPS_QUERY + OPS_TRI * info.num_tris
                         + OPS_ELL * info.num_ellipsoids
                         + OPS_IMP * info.num_implicits + OPS_ROT * n_rot)
        return least(nbytes, ops)

    # ---- 2. kernel vs plain version ---------------------------------------
    def compare(n, width, height, spp, spp_time):
        """Check the kernel against the plain version at `spp` samples
        (the tolerances hold per frame of a few samples: one knife-edge
        divergence ends a pixel's bit equality for all later samples),
        then time both, check them against each other again to the
        TIMED_* limits, and bound the kernel, at `spp_time` samples."""
        whitted = n == 1
        sc, info = scenes.BUILDERS[n]().build(device="cuda")
        cam, rot = (torch.tensor(v, dtype=torch.float32, device=dev)
                    for v in scenes.CAMERAS[n])
        ifd = autofocus_distance(sc, info, cam, rot, 1.0, True)
        state = vrng.seed(torch.arange(width * height, device=dev), 4321)
        kw = dict(width=width, height=height, spp=spp,
                  max_bounces=BOUNCES, blur=0.001, whitted=whitted)
        before = frame.trace_frame.launches
        rad_k, st_k, rays_k = frame.trace_frame(sc, info, cam, rot, ifd,
                                                state, **kw)
        torch.cuda.synchronize()
        check(frame.trace_frame.launches == before + 1,
              "trace_frame did not launch its kernel")
        rad_p, st_p, rays_p = frame.trace_frame_reference(
            sc, info, cam, rot, ifd, state, **kw)
        torch.cuda.synchronize()
        rk, rp = rad_k.cpu().numpy(), rad_p.cpu().numpy()
        diff = np.abs(rk - rp).max(axis=-1)
        state_eq = float((st_k == st_p).float().mean())
        within = float((diff < 1e-4).mean())
        mean_abs = float(np.abs(rk - rp).mean())
        qk, qp = int(rays_k.item()), int(rays_p.item())
        kw["spp"] = spp_time
        out_k = frame.trace_frame(sc, info, cam, rot, ifd, state, **kw)
        q_time = int(out_k[2].item())

        def run():
            return frame.trace_frame(sc, info, cam, rot, ifd, state, **kw)

        ms, wrapper_ms = device_ms(run, "frame_kernel"), cuda_ms(run, 5)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        out_p = frame.trace_frame_reference(sc, info, cam, rot, ifd, state,
                                            **kw)
        b.record()
        torch.cuda.synchronize()
        plain_ms = a.elapsed_time(b)
        # per-sample means at the timed spp
        d_t = ((out_k[0] - out_p[0]) / spp_time).abs()
        off = (d_t.amax(-1) > 1e-3).float()
        timed = {"state_eq": float((out_k[1] == out_p[1]).float().mean()),
                 "frac_off_1e-3": float(off.mean()),
                 "mean_abs": float(d_t.mean()),
                 "queries_plain": int(out_p[2].item())}
        rec = {"phase": "kernel_vs_plain", "config": n,
               "shape": [width, height, spp, BOUNCES],
               "timed_spp": spp_time, "timed_queries": q_time,
               "timed_parity": timed,
               "finite": bool(np.isfinite(rk).all()),
               "state_eq": state_eq, "frac_within_1e-4": within,
               "mean_abs": mean_abs, "max_abs_err": float(diff.max()),
               "queries_kernel": qk, "queries_plain": qp,
               "ms": ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
               **bound(sc, info, width * height, q_time), "card": card}
        emit(rec, log)
        check(rec["finite"], f"config {n}: kernel output not finite")
        check(state_eq >= 0.99, f"config {n}: RNG state equal on {state_eq}")
        check(within >= 0.99, f"config {n}: radiance within 1e-4 on {within}")
        check(mean_abs < 5e-3, f"config {n}: mean abs difference {mean_abs}")
        check(abs(qk - qp) <= 0.01 * qp + 16,
              f"config {n}: queries {qk} vs {qp}")
        check(timed["state_eq"] >= TIMED_STATE_EQ,
              f"config {n}: {spp_time} spp: {timed}")
        check(timed["frac_off_1e-3"] <= TIMED_FRAC_OFF,
              f"config {n}: {spp_time} spp: {timed}")
        check(timed["mean_abs"] < TIMED_MEAN_ABS,
              f"config {n}: {spp_time} spp: {timed}")
        qtp = timed["queries_plain"]
        check(abs(q_time - qtp) <= 0.01 * qtp + 16,
              f"config {n}: {spp_time} spp: queries {q_time} vs {qtp}")
        return rec

    small = {n: compare(n, W_CMP, H_CMP, SPP_CMP, SPP_CMP) for n in MAIN}
    full = {n: compare(n, 800, 600, min(spp, SPP_CMP), spp)
            for n, (spp, _) in MAIN.items()}

    def compare_refill(n, spp_time):
        """The refill schedule of frame_kernel at 800x600: against the plain
        version at 2 spp (the kernel-parity limits), against the default
        schedule at `spp_time` (the same bits: state and radiance equal on
        >= 99.9% of pixels, queries equal), both schedules timed in turns
        (default, refill, refill, default), and the lanes a bounce step
        keeps busy in each (the check-only counting instantiations; their
        lane sum must equal the queries)."""
        sc, info = scenes.BUILDERS[n]().build(device="cuda")
        cam, rot = (torch.tensor(v, dtype=torch.float32, device=dev)
                    for v in scenes.CAMERAS[n])
        ifd = autofocus_distance(sc, info, cam, rot, 1.0, True)
        state = vrng.seed(torch.arange(800 * 600, device=dev), 4321)
        kw = dict(width=800, height=600, spp=SPP_CMP, max_bounces=BOUNCES,
                  blur=0.001)
        before = frame.trace_frame.refill_launches
        rad_k, st_k, rays_k = frame.trace_frame(sc, info, cam, rot, ifd,
                                                state, refill=True, **kw)
        torch.cuda.synchronize()
        check(frame.trace_frame.refill_launches == before + 1,
              "trace_frame(refill=True) did not launch its kernel")
        rad_p, st_p, rays_p = frame.trace_frame_reference(
            sc, info, cam, rot, ifd, state, **kw)
        diff = (rad_k - rad_p).abs().amax(-1)
        qk, qp = int(rays_k.item()), int(rays_p.item())
        rec = {"phase": "kernel_vs_plain", "kernel": "frame_kernel refill",
               "config": n, "shape": [800, 600, SPP_CMP, BOUNCES],
               "state_eq": float((st_k == st_p).float().mean()),
               "frac_within_1e-4": float((diff < 1e-4).float().mean()),
               "mean_abs": float((rad_k - rad_p).abs().mean()),
               "max_abs_err": float(diff.max()),
               "finite": bool(torch.isfinite(rad_k).all()),
               "queries_kernel": qk, "queries_plain": qp}
        kw["spp"] = spp_time
        out_r = frame.trace_frame(sc, info, cam, rot, ifd, state,
                                  refill=True, **kw)
        out_d = frame.trace_frame(sc, info, cam, rot, ifd, state, **kw)
        times = {"default": [], "refill": []}
        for schedule in ("default", "refill", "refill", "default"):
            times[schedule].append(device_ms(
                lambda: frame.trace_frame(sc, info, cam, rot, ifd, state,
                                          refill=schedule == "refill", **kw),
                "frame_kernel"))
        lanes = {}
        for schedule in ("default", "refill"):
            out = frame.lane_use(sc, info, cam, rot, ifd, state,
                                 refill=schedule == "refill", **kw)
            used, steps = (int(x) for x in out[3].tolist())
            lanes[schedule] = {
                "lane_sum": used, "warp_steps": steps,
                "lane_use": used / (32.0 * steps),
                "same_frame": float(((out[0] == out_d[0]).all(-1)
                                     & (out[1] == out_d[1])).float().mean())}
        q_time = int(out_r[2].item())
        rec.update({
            "timed_spp": spp_time, "timed_queries": q_time,
            "vs_default": {
                "state_eq": float((out_r[1] == out_d[1]).float().mean()),
                "radiance_eq": float((out_r[0] == out_d[0]).all(-1).float()
                                     .mean()),
                "queries_default": int(out_d[2].item())},
            "ms": min(times["refill"]), "ms_default": min(times["default"]),
            "ms_turns": times, "plain_ms": full[n]["plain_ms"],
            "lanes": lanes, **bound(sc, info, 800 * 600, q_time),
            "card": card})
        emit(rec, log)
        check(rec["finite"], f"refill {n}: not finite")
        check(rec["state_eq"] >= 0.99, f"refill {n}: {rec}")
        check(rec["frac_within_1e-4"] >= 0.99, f"refill {n}: {rec}")
        check(rec["mean_abs"] < 5e-3, f"refill {n}: {rec}")
        check(abs(qk - qp) <= 0.01 * qp + 16, f"refill {n}: queries {rec}")
        vs = rec["vs_default"]
        check(vs["state_eq"] >= 0.999 and vs["radiance_eq"] >= 0.999
              and vs["queries_default"] == q_time,
              f"refill {n}: against the default schedule {vs}")
        for schedule, lane in lanes.items():
            check(lane["lane_sum"] == q_time and lane["same_frame"] >= 0.999
                  and 0.0 < lane["lane_use"] <= 1.0,
                  f"refill {n}: lane count of {schedule} {lane}")
        return rec

    refill_full = {n: compare_refill(n, spp) for n, (spp, raytracing)
                   in MAIN.items() if raytracing}

    # the slice's scenes: the terrain and the OBJ grid
    def terrain_scene(stream_threshold=1 << 16, light=False, obj=None,
                      device="cuda", leaf=TERRAIN_LEAF):
        """bench.py's height function at n = TERRAIN_N as one mesh, a metal
        and a glass sphere on it; `stream_threshold=0` builds the streamed
        LBVH over it instead of the SAH forest, of at most `leaf` triangles
        a leaf. `light` adds an emissive sphere above it with its disk
        light (the legacy modes' light), `obj` an OBJ file as another
        object, built on `device`."""
        n = TERRAIN_N
        ext = 50.0 * (n / 708.0)
        xs = np.linspace(-ext, ext, n)
        X, Z = np.meshgrid(xs, xs)
        Y = (np.sin(X * 0.35) * np.cos(Z * 0.28) * 1.8
             + np.sin(X * 0.09 + 1.3) * 4.0
             + np.random.RandomState(0).rand(n, n) * 0.15)
        P = np.stack([X, Y, Z], axis=-1)
        a, b, c, d = (P[:-1, :-1].reshape(-1, 3), P[1:, :-1].reshape(-1, 3),
                      P[:-1, 1:].reshape(-1, 3), P[1:, 1:].reshape(-1, 3))
        sc = Scene()
        sc.set_constant_sky((0.5, 0.6, 0.9))
        sc.add_material("terrain")
        sc.set_last_mtl("Kd", (0.45, 0.52, 0.38))
        sc.set_last_mtl("Pr", 1.0)
        sc.add_material("metal")
        sc.set_last_mtl("Pm", 1.0)
        sc.set_last_mtl("Pr", 0.05)
        sc.set_last_mtl("Ks", (0.9, 0.85, 0.7))
        sc.set_last_mtl("Kd", (0.9, 0.85, 0.7))
        sc.add_material("glass")
        sc.set_last_mtl("Tr", 0.92)
        sc.set_last_mtl("Ni", 1.5)
        sc.set_last_mtl("illum", 7)
        sc.set_last_mtl("Tf", (0.05, 0.22, 0.25))
        sc.set_last_mtl("Density", 0.8)
        sc.add_mesh(np.concatenate([a, d]), np.concatenate([b, b]),
                    np.concatenate([c, c]), 0)
        sc.add_sphere((-2.5, 7.0, -4.0), 1.5, m=1)
        sc.add_sphere((2.5, 7.0, -5.0), 1.5, m=2)
        if light:
            sc.add_material("light")
            sc.set_last_mtl("Ke", LIGHT_KE)
            sc.add_emissive_sphere((0.0, 16.0, -2.0), 2.0, m=3)
        if obj:
            sc.add_object(obj, material=0)
        t0 = time.perf_counter()
        out = sc.build(RenderConfig(max_tris_in_leaf=leaf,
                                    stream_threshold=stream_threshold),
                       device=device)
        return (*out, time.perf_counter() - t0)

    terrain_cam = ((0.0, 14.0, -50.0 * (TERRAIN_N / 708.0) * 1.16),
                   (0.25, 0.0, 0.0))

    def grid_obj(tmp, side=12):
        """A 12x12 jittered triangle grid written to an OBJ file in `tmp`
        (`side` x `side` triangles over the same square for another size);
        returns its path."""
        rng = np.random.RandomState(0)
        lines, faces = ["o grid"], []
        scale = 12 / side
        for i in range(side):
            for k in range(side):
                bx, bz, by = i * 0.7 * scale, k * 0.7 * scale, rng.rand() * 1.5
                edge = 0.6 * scale
                for v in ((bx, by, bz),
                          (bx + edge, by + rng.randn() * 0.3, bz),
                          (bx, by + rng.randn() * 0.3, bz + edge)):
                    lines.append("v %.5f %.5f %.5f" % v)
                n = 3 * len(faces)
                faces.append(f"f {n + 1} {n + 2} {n + 3}")
        path = os.path.join(tmp, f"grid{side}.obj")
        with open(path, "w") as f:
            f.write("\n".join(lines + faces) + "\n")
        return path

    def grid_scene(tmp, side=12, device="cuda", light=False):
        """The grid of `grid_obj` loaded through Scene.add_object, a glass
        sphere beside it (and with `light` an emissive sphere with its disk
        light above it), built on `device`."""
        path = grid_obj(tmp, side)
        sc = Scene()
        sc.set_constant_sky((0.5, 0.6, 0.9))
        sc.add_material("grid")
        sc.set_last_mtl("Kd", (0.6, 0.55, 0.4))
        sc.set_last_mtl("Pr", 0.9)
        sc.add_material("glass")
        sc.set_last_mtl("Tr", 0.92)
        sc.set_last_mtl("Ni", 1.5)
        sc.set_last_mtl("illum", 7)
        sc.add_object(path, material=0)
        sc.add_sphere((4.2, 2.4, 3.0), 0.9, m=1)
        if light:
            sc.add_material("light")
            sc.set_last_mtl("Ke", LIGHT_KE)
            sc.add_emissive_sphere((4.2, 7.0, 6.0), 1.0, m=2)
        return sc.build(RenderConfig(max_tris_in_leaf=TERRAIN_LEAF),
                        device=device)

    grid_cam = ((4.2, 3.2, -1.5), (0.55, 0.0, 0.0))
    terrain, terrain_info, terrain_build_s = terrain_scene()
    with tempfile.TemporaryDirectory() as tmp:
        grid, grid_info = grid_scene(tmp)
        grid_cpu = grid_scene(tmp, device="cpu")   # for the session's picks
    emit({"phase": "scenes", "terrain_tris": terrain_info.num_tris,
          "terrain_leaves": terrain_info.num_leaves,
          "terrain_depth": terrain_info.forest_depth,
          "terrain_build_s": terrain_build_s,
          "grid_tris": grid_info.num_tris,
          "grid_leaves": grid_info.num_leaves}, log)
    check(terrain_info.num_tris == 2 * (TERRAIN_N - 1) ** 2
          and not wavefront.use_brute(terrain_info),
          "the terrain must go to traverse_kernel")
    check(wavefront.use_brute(grid_info) and fused.eligible(grid_info),
          "the OBJ grid must go to brute_kernel and block_kernel")

    def sample_rays(cam, rot, width, height, seed=4321, focus=20.0,
                    blur=0.001):
        """One sample's rays of a camera, as the renderer makes them."""
        cam, rot = (torch.tensor(v, dtype=torch.float32, device=dev)
                    for v in (cam, rot))
        state = vrng.seed(torch.arange(width * height, device=dev), seed)
        o, d, state = frame._raygen(
            cam, vm.rotation_matrix(rot), torch.tensor(focus, device=dev),
            state, width, height, cam_size=1.5, focal_length=1.0, blur=blur)
        return [c.contiguous() for c in o], [c.contiguous() for c in d], state

    def query_rays(cam, rot, lo, hi, random_rays):
        """(o, d, t_init) of a kernel comparison: the camera's primary rays
        at 800x600 and, with `random_rays`, as many random rays from above
        the box lo, hi of the scene; one ray in seven switched off."""
        o, d, _ = sample_rays(cam, rot, 800, 600)
        n = o[0].shape[0]
        if random_rays:
            g = torch.Generator(device="cpu").manual_seed(7)
            ro = lo + (hi - lo) * torch.rand(n, 3, generator=g) \
                + torch.tensor([0.0, 3.0, 0.0])
            # from above the scene, mostly downwards
            rd = torch.randn(n, 3, generator=g) \
                + torch.tensor([0.0, -1.0, 0.0])
            rd = rd / rd.norm(dim=1, keepdim=True)
            o = tuple(torch.cat([o[i], ro[:, i].to(dev)]) for i in range(3))
            d = tuple(torch.cat([d[i], rd[:, i].to(dev)]) for i in range(3))
            n = 2 * n
        t_init = torch.where(torch.arange(n, device=dev) % 7 == 0, 0.0, 1e30)
        return o, d, t_init

    def forest_box(sc):
        root_boxes = sc.nodes_f[sc.roots.to(torch.int64)].cpu()
        return root_boxes[:, 0:3].amin(0), root_boxes[:, 3:6].amax(0)

    def hit_error(out_k, out_p, same):
        """(largest difference of u, v where both hit the same row, largest
        difference of t relative to 1 + t where both hit at all)."""
        uv = max(float((x[same] - y[same]).abs().max())
                 for x, y in ((out_k[1], out_p[1]), (out_k[2], out_p[2])))
        tk, tp = out_k[0], out_p[0]
        t_rel = ((tk - tp).abs() / (1.0 + tp.abs()))[(tk < 1e29)
                                                     & (tp < 1e29)]
        return uv, float(t_rel.max()) if t_rel.numel() else 0.0

    def fetch_rounds(box, leaf, live, info):
        """The walk's dependent fetches a live ray, worked out from its
        counters and not measured (2 box tests an inner node, 1 a leaf):
        nodes_f and nodes_i made a node wait on its ids, then its
        children's boxes, and a leaf on its ids, then its rows (box + 2
        leaf); nodes_w makes a node wait on its one record and a leaf on
        its rows (box / 2 + leaf). Both pop the local stack alike: at
        least once after each leaf but an object's last."""
        n = max(int(live.sum()), 1)
        box, leaf = int(box[live].sum()), leaf[live]
        return {"fetch_rounds_per_live_ray": {
            "nodes_f_nodes_i": (box + 2 * int(leaf.sum())) / n,
            "nodes_w": (box / 2 + int(leaf.sum())) / n,
            "pops_at_least": int((leaf - info.num_objects).clamp(min=0)
                                 .sum()) / n}}

    cell_rays = {}

    def cell_walks():
        """{label: (scene, info, o, d, t_init)}: the first and the third
        walk of one sample of the cell terrain181.progressive, as
        traverse._query hands them to trace_forest. The cell's scene is
        the terrain at one triangle a leaf under terrain_cam, its camera
        rays 800x600 with the cell's focal distance 1.0 and no blur."""
        if cell_rays:
            return cell_rays
        sc, info, build_s = terrain_scene(leaf=1)
        o, d, state = sample_rays(*terrain_cam, 800, 600, focus=1.0,
                                  blur=0.0)
        alive = torch.ones(state.shape, dtype=torch.bool, device=dev)
        queries = []

        def walk(o, d, alive):
            on = traverse.nudged(o, d)
            queries.append(tuple(c.clone() for c in (
                *on, *d, traverse._t_init(on[0], alive))))
            return traverse.walk_triangles(o, d, sc, info, active=alive)

        st = bounce.begin(o, d, alive, state, stack_size=10)
        integrator._run_bounces(walk, bounce.bounce_step, sc, info, st,
                                max_bounces=3)
        leaf_sizes = sc.nodes_i[sc.nodes_i[:, 0] < 0, 3]
        emit({"phase": "scenes", "terrain181_tris": info.num_tris,
              "terrain181_leaves": info.num_leaves,
              "terrain181_depth": info.forest_depth,
              "terrain181_build_s": build_s}, log)
        check(info.num_tris == 2 * (TERRAIN_N - 1) ** 2
              and int(leaf_sizes.max()) == 1
              and not wavefront.use_brute(info),
              f"terrain181: leaves of {int(leaf_sizes.max())} triangles")
        for label, k in (("terrain181_camera", 0), ("terrain181_bounce3", 2)):
            q = queries[k]
            cell_rays[label] = (sc, info, q[0:3], q[3:6], q[6])
        return cell_rays

    def compare_forest(kernel, sc, info, cam=None, rot=None,
                       random_rays=True, rays=None, label=None):
        """A forest kernel against its plain version on `query_rays`, or
        on `rays` (o, d, t_init), then named `label` and required equal in
        all six outputs."""
        o, d, t_init = rays or query_rays(cam, rot, *forest_box(sc),
                                          random_rays)
        n = t_init.shape[0]
        live = t_init > 0.0
        before = wavefront.launches[kernel]
        out_k = wavefront.trace_forest(o, d, t_init, sc, info)
        torch.cuda.synchronize()
        check(wavefront.launches[kernel] == before + 1,
              f"trace_forest did not launch {kernel}")
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        out_p = wavefront.trace_forest_reference(o, d, t_init, sc, info)
        b.record()
        torch.cuda.synchronize()
        plain_ms = a.elapsed_time(b)
        ms = device_ms(lambda: wavefront.trace_forest(o, d, t_init, sc, info),
                       kernel)
        wrapper_ms = cuda_ms(
            lambda: wavefront.trace_forest(o, d, t_init, sc, info), 5)
        tk, uk, vk, ik, bk, lk = out_k
        tp, up, vp, ip, bp, lp = out_p
        same = ik == ip
        err = max(hit_error(out_k, out_p, same))
        box, leaf = int(bk.sum()), int(lk.sum())
        # triangle tests the counters prove: every row for a live ray of
        # the brute kernel; for the walk, the smallest leaf's triangles at
        # each leaf visit
        leaf_sizes = sc.nodes_i[sc.nodes_i[:, 0] < 0, 3]
        tri_tests = (int(live.sum()) * info.num_tris if kernel
                     == "brute_kernel" else leaf * int(leaf_sizes.min()))
        rec = {"phase": "kernel_vs_plain", "kernel": kernel,
               **({"rays_of": label} if label else {}),
               "rays": n, "live_rays": int(live.sum()),
               "tris": info.num_tris, "leaves": info.num_leaves,
               "hit_share": float((ik >= 0).float().mean()),
               "idx_eq": float(same.float().mean()), "max_abs_err": err,
               "t_miss_eq": bool(((tk > 1e29) == (tp > 1e29)).all()),
               "box_eq": float((bk == bp).float().mean()),
               "leaf_eq": float((lk == lp).float().mean()),
               "dead_exact": bool(((tk == 0.0) & (ik == -1) & (bk == 0)
                                   & (lk == 0))[~live].all()),
               "box_tests": box, "leaf_visits": leaf,
               "tri_tests_at_least": tri_tests, "ms": ms,
               "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
               **least(n * (28 + 24) + table_bytes(sc, FOREST_TABLES[kernel]),
                       box * OPS_BOX + tri_tests * OPS_TRI_DIV),
               "card": card}
        if kernel == "traverse_kernel":
            rec.update(fetch_rounds(bk, lk, live, info))
        if label:
            rec["equal"] = {k: bool(torch.equal(a, b)) for k, a, b in zip(
                ("t", "u", "v", "idx", "box", "leaf"), out_k, out_p)}
        emit(rec, log)
        check(rec["idx_eq"] >= 0.999, f"{kernel}: rows equal on {rec}")
        check(err <= 1e-5, f"{kernel}: t, u, v differ by {err}")
        check(rec["t_miss_eq"] and rec["dead_exact"], f"{kernel}: {rec}")
        if label:
            check(all(rec["equal"].values()) and rec["hit_share"] > 0.0,
                  f"{kernel} on {label}: {rec}")
            return rec
        check(0.02 < rec["hit_share"] < 0.95, f"{kernel}: hits {rec}")
        if kernel == "traverse_kernel":
            check(rec["box_eq"] >= 0.999 and rec["leaf_eq"] >= 0.999,
                  f"{kernel}: counters {rec}")
        else:
            check(rec["box_eq"] == 1.0 and rec["leaf_eq"] == 1.0,
                  f"{kernel}: counters {rec}")
        return rec

    def compare_block(label, sc, info, cam, rot):
        """block_kernel against integrator.trace_plain on the scene's rays
        of one sample at 800x600, at the 2-spp limits."""
        o, d, state = sample_rays(cam, rot, 800, 600)
        alive = torch.ones(state.shape, dtype=torch.bool, device=dev)
        kw = dict(max_bounces=BOUNCES)
        before = fused.trace_block.launches
        rad_k, st_k, q_k = fused.trace_block(sc, info, o, d, alive, state,
                                             **kw)
        torch.cuda.synchronize()
        check(fused.trace_block.launches == before + 1,
              "trace_block did not launch block_kernel")
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        inc, skyc, st_p, q_p = integrator.trace_plain(sc, info, o, d, alive,
                                                      state, **kw)
        b.record()
        torch.cuda.synchronize()
        plain_ms = a.elapsed_time(b)
        ms = device_ms(lambda: fused.trace_block(sc, info, o, d, alive,
                                                 state, **kw), "block_kernel")
        wrapper_ms = cuda_ms(lambda: fused.trace_block(sc, info, o, d, alive,
                                                       state, **kw), 5)
        rk = torch.stack(list(rad_k), -1)
        rp = torch.stack([inc[i] + skyc[i] for i in range(3)], -1)
        diff = (rk - rp).abs().amax(-1)
        qk, qp = int(q_k), int(q_p.sum())
        rec = {"phase": "kernel_vs_plain", "kernel": "block_kernel",
               "scene": label, "rays": int(state.numel()),
               "finite": bool(torch.isfinite(rk).all()),
               "state_eq": float((st_k == st_p).float().mean()),
               "frac_within_1e-4": float((diff < 1e-4).float().mean()),
               "mean_abs": float((rk - rp).abs().mean()),
               "max_abs_err": float(diff.max()), "queries_kernel": qk,
               "queries_plain": qp, "ms": ms, "wrapper_ms": wrapper_ms,
               "plain_ms": plain_ms,
               **bound(sc, info, int(state.numel()), qk,
                       ray_bytes=24 + 1 + 8 + 8 + 12), "card": card}
        emit(rec, log)
        check(rec["finite"], "block_kernel: output not finite")
        check(rec["state_eq"] >= 0.99, f"block_kernel: {rec}")
        check(rec["frac_within_1e-4"] >= 0.99, f"block_kernel: {rec}")
        check(rec["mean_abs"] < 5e-3, f"block_kernel: {rec}")
        check(abs(qk - qp) <= 0.01 * qp + 16, f"block_kernel: {rec}")
        block_phases(label, sc, info, o, d, alive, state, rad_k, st_k, qk)
        return rec

    def block_phases(label, sc, info, o, d, alive, state, rad_k, st_k, qk):
        """block_kernel's check-only instantiations on the same rays: the
        share of a warp's lanes a bounce step keeps busy (LANES) and of its
        cycles each part of a scene query takes (PHASES); both give the
        kernel's outputs."""
        kw = dict(max_bounces=BOUNCES)
        before = fused.trace_block.launches
        *out_l, lanes = fused.trace_block(sc, info, o, d, alive, state,
                                          check="lanes", **kw)
        *out_p, cyc = fused.trace_block(sc, info, o, d, alive, state,
                                        check="phases", **kw)
        used, steps = lanes.tolist()
        shares = {k: v / cyc["warp"] for k, v in cyc.items() if k != "warp"}
        same = all(torch.equal(torch.stack(list(out[0])), torch.stack(
            list(rad_k))) and torch.equal(out[1], st_k) and int(out[2]) == qk
            for out in (out_l, out_p))
        rec = {"phase": "block_phases", "scene": label,
               "rays": int(state.numel()), "bounces": BOUNCES,
               "lanes_busy_share": used / (32 * steps), "lanes": used,
               "warp_steps": steps, "shares": shares,
               "rest": 1.0 - sum(shares.values()), "cycles": cyc,
               "same_outputs": same, "card": card}
        emit(rec, log)
        check(same and used == qk and cyc["warp"] > 0
              and fused.trace_block.launches == before,
              f"block_kernel check instantiations, {label}: {rec}")
        block_phases_rec[label] = rec

    block_phases_rec = {}
    compare_forest("brute_kernel", grid, grid_info, *grid_cam)
    # the records of the `kernels` line: the batches the main path launches
    brute_rec = compare_forest("brute_kernel", grid, grid_info, *grid_cam,
                               random_rays=False)
    walk_rec = compare_forest("traverse_kernel", terrain, terrain_info,
                              *terrain_cam)
    # and on the inputs of the cell terrain181.progressive
    for label, (sc, info, o, d, t_init) in cell_walks().items():
        compare_forest("traverse_kernel", sc, info, rays=(o, d, t_init),
                       label=label)
    compare_block("config6", *scenes.BUILDERS[6]().build(device="cuda"),
                  *scenes.CAMERAS[6])
    block_rec = compare_block("obj_grid", grid, grid_info, *grid_cam)

    def block_stage_min():
        """block_kernel's two forms, the plain triangle loop and the staged
        rows with the early exit (fused.STAGE_MIN picks one by the scene's
        triangle count), on one sample's rays at 800x600 of grids of 4 to
        144 triangles over the OBJ grid's square and of config 6, timed in
        turns (plain, staged, staged, plain, plain, staged; the median of
        each side), their outputs compared: from how many triangles staging
        pays."""
        with tempfile.TemporaryDirectory() as tmp:
            cases = [(f"grid_{side * side}", *grid_scene(tmp, side),
                      *grid_cam) for side in STAGE_GRID_SIDES]
        cases.append(("config6", *scenes.BUILDERS[6]().build(device="cuda"),
                      *scenes.CAMERAS[6]))
        saved, recs = fused.STAGE_MIN, {}
        try:
            for label, sc, info, cam, rot in cases:
                o, d, state = sample_rays(cam, rot, 800, 600)
                alive = torch.ones(state.shape, dtype=torch.bool, device=dev)

                def run():
                    return fused.trace_block(sc, info, o, d, alive, state,
                                             max_bounces=BOUNCES)

                outs, times = {}, {"plain": [], "staged": []}
                for form in ("plain", "staged", "staged", "plain", "plain",
                             "staged"):
                    fused.STAGE_MIN = 1 if form == "staged" else 1 << 30
                    outs[form] = run()
                    times[form].append(device_ms(run, "block_kernel"))
                (rad_p, st_p, q_p), (rad_s, st_s, q_s) = (
                    outs["plain"], outs["staged"])
                ms = {form: sorted(t)[1] for form, t in times.items()}
                rec = {"phase": "block_stage_min", "scene": label,
                       "triangles": info.num_tris, "rays": int(state.numel()),
                       "ms_plain": ms["plain"], "ms_staged": ms["staged"],
                       "staged_over_plain": ms["staged"] / ms["plain"],
                       "ms_turns": times,
                       "state_eq": float((st_p == st_s).float().mean()),
                       "rad_eq": float((torch.stack(rad_p) == torch.stack(
                           rad_s)).all(0).float().mean()),
                       "queries_eq": int(q_p) == int(q_s), "card": card}
                emit(rec, log)
                check(rec["state_eq"] >= 0.999 and rec["rad_eq"] >= 0.999
                      and rec["queries_eq"], f"block_kernel forms: {rec}")
                recs[label] = rec
        finally:
            fused.STAGE_MIN = saved
        return recs

    stage_min_rec = block_stage_min()

    # the streamed route's scenes: the scale benchmark's terrain, and the
    # n = 181 terrain built streamed
    def big_scene():
        """scenes.terrain(BIG_N) built on the card as a user builds it, and
        beside it the seconds of the same build on the CPU device (all but
        the upload), of copying that scene's tensors to the card, and of
        the LBVH builder alone; and the CPU device's scene and info."""
        sc = scenes.terrain(BIG_N)
        t0 = time.perf_counter()
        scene, info = sc.build()
        torch.cuda.synchronize()
        seconds = {"build_s": time.perf_counter() - t0}
        t0 = time.perf_counter()
        host, host_info = sc.build(device="cpu")
        seconds["host_build_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        moved = [getattr(host, f.name).to(dev)
                 for f in dataclasses.fields(host)]
        torch.cuda.synchronize()
        seconds["upload_s"] = time.perf_counter() - t0
        seconds["upload_bytes"] = sum(t.numel() * t.element_size()
                                      for t in moved)
        mesh = sc.bulk_meshes[0]
        t0 = time.perf_counter()
        lbvh.build_streamed(mesh["v1"], mesh["v2"], mesh["v3"])
        seconds["lbvh_s"] = time.perf_counter() - t0
        return scene, info, seconds, (host, host_info)

    big, big_info, big_seconds, big_host = big_scene()
    big_cam = scenes.terrain_camera(BIG_N)
    terrain_st, terrain_st_info, _ = terrain_scene(stream_threshold=0)
    emit({"phase": "scenes", "big_tris": big_info.num_tris,
          "big_treelets": big_info.st_n_treelets,
          "big_slots": int(big.st_tris.shape[0]), **big_seconds,
          "terrain_streamed_treelets": terrain_st_info.st_n_treelets},
         log)
    check(big_info.streamed and big_info.num_tris == 2 * (BIG_N - 1) ** 2
          and big_info.num_objects == 0,
          "the 1M-triangle terrain must be a streamed scene")
    check(terrain_st_info.streamed
          and terrain_st_info.num_tris == terrain_info.num_tris,
          "the n = 181 terrain must build streamed too")

    def streamed_population(sc, cam, rot, random_rays, sort):
        """`query_rays` of a streamed scene, with `sort` in the order the
        route hands them to the kernel (traverse.streamed_order)."""
        top = sc.st_top[0].cpu()
        o, d, t_init = query_rays(cam, rot, top[0:3], top[3:6], random_rays)
        if sort:
            order = traverse.streamed_order(o, d, t_init, sc)
            o, d = (tuple(c[order].contiguous() for c in v) for v in (o, d))
            t_init = t_init[order].contiguous()
        return o, d, t_init

    # the 1M terrain's rays: the camera's 480,000 primary rays and 960,000
    # mixed ones, each as given and as the route sorts them
    streamed_pops = {
        f"{'mixed' if mixed else 'primary'}{'_sorted' if srt else ''}":
            streamed_population(big, *big_cam, mixed, srt)
        for mixed in (True, False) for srt in (False, True)}

    def sort_cost(sc, info, o, d, t_init):
        """ms of the route's sort of a query on the card (events around 5
        calls): the PyTorch key alone, the argsort alone, the order (key,
        root box test, argsort), and the order with the gathers before the
        kernel and the scatters after it (the kernel left out); then the
        whole query both ways in turns, from the origins before the nudge:
        `sorted_query` over streamed_kernel (the nudge, t_init, the order,
        the gathers, the walk, the scatters; `query_torch_ms`) and
        `wavefront.trace_sorted` (sort_key_kernel, the argsort, the ordered
        walk; `query_ordered_ms`), and whether the two give the same bits;
        and sort_key_kernel alone (device time of 20 launches back to back)
        against its plain twin (`nudged`, then `streamed_keys`): its keys
        and nudged origins, which must equal the twin's, its time and its
        bound (the rays' bytes over the memory rate)."""
        outs = wavefront.trace_streamed(o, d, t_init, sc, info)
        o3, d3 = torch.stack(o, -1), torch.stack(d, -1)
        lo, hi = sc.st_top[0, 0:3], sc.st_top[0, 3:6]
        key = traverse.spatial_sort_key(o3, d3, lo, hi)
        active = t_init > 0.0

        def torch_query():
            on = traverse.nudged(o, d)
            return traverse.sorted_query(
                wavefront.trace_streamed, on, d,
                traverse._t_init(on[0], active), sc, info)

        def ordered_query():
            return wavefront.trace_sorted(o, d, active, sc, info)[1]

        same = all(bool(torch.equal(a, b))
                   for a, b in zip(torch_query(), ordered_query()))
        root = sc.st_top[0, 0:6]

        def plain_keys():
            on = traverse.nudged(o, d)
            return on, traverse.streamed_keys(on, d, t_init, root)

        (on, want), (key_on, got) = (
            plain_keys(), wavefront.sort_keys(o, d, active, sc, info))
        n = int(t_init.shape[0])
        # read o, d and the mask, write the nudged origins and the key
        key_bytes = n * (12 + 12 + active.element_size() + 12 + 4) + 24
        rec = {"key_ms": cuda_ms(
                    lambda: traverse.spatial_sort_key(o3, d3, lo, hi), 5),
               "argsort_ms": cuda_ms(
                    lambda: torch.argsort(key, stable=True), 5),
               "order_ms": cuda_ms(
                    lambda: traverse.streamed_order(o, d, t_init, sc), 5),
               "sort_ms": cuda_ms(lambda: traverse.sorted_query(
                    lambda *_: outs, o, d, t_init, sc, info), 5),
               "sort_key_kernel_ms": device_ms(
                    lambda: wavefront.sort_keys(o, d, active, sc, info),
                    "sort_key_kernel"),
               "plain_keys_ms": cuda_ms(plain_keys, 5),
               "sort_key_bound": least(key_bytes, 6 * n),
               "keys_equal": bool(torch.equal(got, want)),
               "nudged_equal": all(bool(torch.equal(a, b))
                                   for a, b in zip(key_on, on)),
               "key_max_abs_err": max(
                   float((got.long() - want.long()).abs().max()),
                   *(float((a - b).abs().max())
                     for a, b in zip(key_on, on))),
               "ordered_same_bits": same}
        for name, fn in (("query_torch_ms", torch_query),
                         ("query_ordered_ms", ordered_query),
                         ("query_ordered_ms", ordered_query),
                         ("query_torch_ms", torch_query)):
            rec.setdefault(name, []).append(cuda_ms(fn, 5))
        check(same, f"the ordered query's bits differ from sorted_query's "
              f"{rec}")
        check(rec["keys_equal"] and rec["nudged_equal"],
              f"sort_key_kernel differs from its plain twin: {rec}")
        return rec

    def streamed_phases(label, sc, info, o, d, t_init):
        """Where a warp's cycles go in streamed_kernel (the check-only
        PHASES instantiation), how many distinct groups the lanes of a
        warp test at once, and how often the row cull engages: the rows
        tested and the row boxes tested per group entered (4 and 4 without
        the cull)."""
        *out, cyc = wavefront.streamed_phase_cycles(o, d, t_init, sc, info)
        ref = wavefront.trace_streamed(o, d, t_init, sc, info)
        live = max(int((t_init > 0.0).sum()), 1)
        tests = max(cyc["group_tests"], 1)
        groups = max(int(out[5].sum()) // lbvh.SUB_GROUP_ROWS, 1)
        shares = {k: cyc[k] / cyc["warp"]
                  for k in ("top_box", "sub_box", "group", "stack")}
        rec = {"phase": "streamed_phases", "population": label,
               "rays": int(t_init.shape[0]), "live_rays": live,
               "shares": shares, "rest": 1.0 - sum(shares.values()),
               "cycles": cyc,
               "lanes_per_group_test": cyc["group_lanes"] / tests,
               "distinct_groups_per_group_test":
                   cyc["group_distinct"] / tests,
               "box_tests_per_live_ray": int(out[4].sum()) / live,
               "row_visits_per_live_ray": int(out[5].sum()) / live,
               "rows_tested_per_group_entered": cyc["rows_tested"] / groups,
               "row_boxes_per_group_entered": cyc["row_boxes"] / groups,
               "slot_tests_per_live_ray":
                   cyc["rows_tested"] * lbvh.TRIS_PER_ROW / live,
               "same_outputs": all(bool(torch.equal(a, b))
                                   for a, b in zip(out, ref)),
               "card": card}
        emit(rec, log)
        check(rec["same_outputs"] and cyc["warp"] > 0,
              f"streamed PHASES {label}: {rec}")
        check(rec["row_boxes_per_group_entered"] == lbvh.SUB_GROUP_ROWS
              and rec["rows_tested_per_group_entered"] < lbvh.SUB_GROUP_ROWS,
              f"streamed PHASES {label}: the row cull {rec}")
        return rec

    def compare_streamed(label, sc, info, o, d, t_init):
        """streamed_kernel against streamed_reference on the rays o, d."""
        n = t_init.shape[0]
        live = t_init > 0.0
        before = wavefront.launches["streamed_kernel"]
        out_k = wavefront.trace_streamed(o, d, t_init, sc, info)
        torch.cuda.synchronize()
        check(wavefront.launches["streamed_kernel"] == before + 1,
              "trace_streamed did not launch streamed_kernel")
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        out_p = wavefront.streamed_reference(o, d, t_init, sc, info)
        b.record()
        torch.cuda.synchronize()
        plain_ms = a.elapsed_time(b)
        ms = device_ms(lambda: wavefront.trace_streamed(o, d, t_init, sc,
                                                        info),
                       "streamed_kernel")
        wrapper_ms = cuda_ms(
            lambda: wavefront.trace_streamed(o, d, t_init, sc, info), 5)
        tk, _, _, ik, bk, rk = out_k
        tp, _, _, ip, bp, rp = out_p
        same = ik == ip
        box, rows = int(bk.sum()), int(rk.sum())
        # each visited row and box once: the plain walk marks, in a pass
        # of its own, the distinct boxes that some ray tests (6 floats
        # each) and the distinct groups that some ray enters (4 row boxes
        # of 6 floats; at most 4 rows of 14 triangles of 9 floats), and
        # counts the rows its row cull tests (14 slot tests each)
        n_tl = info.st_n_treelets
        marks = (torch.zeros(2 * n_tl - 1 + 64 * n_tl, dtype=torch.bool,
                             device=dev),
                 torch.zeros(32 * n_tl, dtype=torch.bool, device=dev))
        tested = torch.zeros(n, dtype=torch.int32, device=dev)
        wavefront.streamed_reference(o, d, t_init, sc, info, visited=marks,
                                     rows_tested=tested)
        boxes_read, groups_read = (int(m.sum()) for m in marks)
        tri_tests = int(tested.sum()) * lbvh.TRIS_PER_ROW
        visited = (boxes_read * 24 + groups_read * lbvh.SUB_GROUP_ROWS
                   * (24 + lbvh.TRIS_PER_ROW * 36))
        rec = {"phase": "kernel_vs_plain", "kernel": "streamed_kernel",
               "scene": label, "rays": n, "live_rays": int(live.sum()),
               "tris": info.num_tris, "treelets": info.st_n_treelets,
               "hit_share": float((ik >= 0).float().mean()),
               "idx_eq": float(same.float().mean()),
               "max_abs_err": max(hit_error(out_k, out_p, same)),
               "t_miss_eq": bool(((tk > 1e29) == (tp > 1e29)).all()),
               "box_eq": float((bk == bp).float().mean()),
               "rows_eq": float((rk == rp).float().mean()),
               "dead_exact": bool(((tk == 0.0) & (out_k[1] == 0.0)
                                   & (out_k[2] == 0.0) & (ik == -1)
                                   & (bk == 0) & (rk == 0))[~live].all()),
               "box_tests": box, "row_visits": rows, "tri_tests": tri_tests,
               "rows_tested": tri_tests // lbvh.TRIS_PER_ROW,
               "distinct_boxes": boxes_read,
               "distinct_rows": groups_read * lbvh.SUB_GROUP_ROWS,
               "table_bytes_read": visited,
               "box_tests_per_live_ray": box / max(int(live.sum()), 1),
               "row_visits_per_live_ray": rows / max(int(live.sum()), 1),
               "ms": ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
               **least(n * (28 + 24) + visited,
                       (box + rows) * OPS_BOX + tri_tests * OPS_TRI_FREE),
               "card": card}
        emit(rec, log)
        check(rec["idx_eq"] >= 0.999, f"streamed_kernel: slots equal {rec}")
        check(rec["max_abs_err"] <= 1e-5, f"streamed_kernel: t, u, v {rec}")
        check(rec["t_miss_eq"] and rec["dead_exact"],
              f"streamed_kernel: {rec}")
        check(0.02 < rec["hit_share"] < 0.98, f"streamed_kernel: hits {rec}")
        check(rec["box_eq"] >= 0.999 and rec["rows_eq"] >= 0.999,
              f"streamed_kernel: counters {rec}")
        return rec

    def compare_streamed_with_walk():
        """The n = 181 terrain built both ways: streamed_kernel over the
        LBVH against traverse_kernel over the SAH forest, the same rays.
        A division-free against a dividing triangle test: triangle id equal
        on >= 99.9%, t within 1e-4 (1 + t); u and v, whose error grows as
        the determinant shrinks, are recorded."""
        o, d, t_init = query_rays(*terrain_cam, *forest_box(terrain), True)
        out_s = wavefront.trace_streamed(o, d, t_init, terrain_st,
                                         terrain_st_info)
        out_f = wavefront.trace_forest(o, d, t_init, terrain, terrain_info)
        tri_s = torch.where(
            out_s[3] >= 0,
            terrain_st.st_perm[out_s[3].clamp(min=0).to(torch.int64)], -1)
        tri_f = torch.where(
            out_f[3] >= 0,
            terrain.wf_perm[out_f[3].clamp(min=0).to(torch.int64)], -1)
        same = tri_s == tri_f
        uv_err, t_err = hit_error(out_s, out_f, same)
        both = (out_s[0] < 1e29) & (out_f[0] < 1e29) & (t_init > 0.0)
        t_abs = float((out_s[0] - out_f[0]).abs()[both].max())
        rec = {"phase": "streamed_vs_walk", "scene": "terrain",
               "rays": int(t_init.shape[0]), "tris": terrain_info.num_tris,
               "tri_eq": float(same.float().mean()),
               "max_abs_err": t_err, "t_max_abs_err": t_abs,
               "uv_max_abs_err": uv_err,
               "hit_share": float((tri_s >= 0).float().mean()),
               "streamed_ms": device_ms(lambda: wavefront.trace_streamed(
                   o, d, t_init, terrain_st, terrain_st_info),
                   "streamed_kernel"),
               "walk_ms": device_ms(lambda: wavefront.trace_forest(
                   o, d, t_init, terrain, terrain_info), "traverse_kernel"),
               "card": card}
        emit(rec, log)
        check(rec["tri_eq"] >= 0.999, f"streamed against the walk: {rec}")
        check(rec["max_abs_err"] <= 1e-4, f"streamed against the walk: {rec}")
        check(0.02 < rec["hit_share"] < 0.95,
              f"streamed against the walk: {rec}")

    streamed_recs = {pop: compare_streamed(f"terrain_1m_{pop}", big,
                                           big_info, *rays)
                     for pop, rays in streamed_pops.items()}
    for pop in ("primary", "mixed"):
        streamed_recs[f"{pop}_sorted"].update(
            sort_cost(big, big_info, *streamed_pops[pop]))
    # the record of the `kernels` line: the batch the main path launches,
    # its primary rays as the route sorts them
    streamed_rec = streamed_recs["primary_sorted"]
    streamed_rec["unsorted"] = {k: streamed_recs["primary"][k] for k in (
        "ms", "wrapper_ms", "box_tests_per_live_ray",
        "row_visits_per_live_ray")}
    streamed_phases_rec = {pop: streamed_phases(pop, big, big_info, *rays)
                           for pop, rays in streamed_pops.items()}
    compare_streamed_with_walk()

    # frame_kernel's cycles by part of a scene query, and the parents
    def frame_cells():
        """(config, refill, (scene, info, cam, rot, ifd, state), kwargs) of
        the frame path's cells at 800x600 and the main path's spp, both
        schedules in path mode."""
        for n, (spp, raytracing) in MAIN.items():
            sc, info = scenes.BUILDERS[n]().build(device="cuda")
            cam, rot = (torch.tensor(v, dtype=torch.float32, device=dev)
                        for v in scenes.CAMERAS[n])
            ifd = autofocus_distance(sc, info, cam, rot, 1.0, True)
            state = vrng.seed(torch.arange(800 * 600, device=dev), 4321)
            for refill in (False, True) if raytracing else (False,):
                yield n, refill, (sc, info, cam, rot, ifd, state), dict(
                    width=800, height=600, spp=spp, max_bounces=BOUNCES,
                    blur=0.001, whitted=not raytracing, refill=refill)

    def phase_shares(module, args, kw):
        """(output, {part: share of the warps' cycles}) of a frame through
        `module`'s check-only PHASES instantiation."""
        out = module.phase_cycles(*args, **kw)
        cyc = out[3]
        return out, {k: v / cyc["warp"] for k, v in cyc.items()
                     if k != "warp"}

    def same_frame(a, b):
        return float(((a[0] == b[0]).all(-1) & (a[1] == b[1])).float()
                     .mean())

    phases_rec = {}
    for n, refill, args, kw in frame_cells():
        out, shares = phase_shares(frame, args, kw)
        cell = f"{n} refill" if refill else str(n)
        rec = {"phase": "phases", "config": n,
               "schedule": "refill" if refill else "default",
               "shape": [800, 600, kw["spp"], BOUNCES], "shares": shares,
               "rest": 1.0 - sum(shares.values()), "cycles": out[3],
               "same_frame": same_frame(out, frame.trace_frame(*args, **kw)),
               "card": card}
        phases_rec[cell] = rec
        emit(rec, log)
        check(rec["same_frame"] >= 0.999 and out[3]["warp"] > 0,
              f"PHASES {cell}: {rec}")

    def same_share(out_p, out_c, names):
        """{output: share of the rays on which the two are equal}."""
        return {k: float((a == b).float().mean())
                for k, a, b in zip(names, out_p, out_c)}

    def turns(tree, fn_parent, fn_change, key):
        """Device ms of kernel `key` through another checkout's call and
        this one's, in turns: the median of three each."""
        times = {"parent": [], "change": []}
        for who in ("parent", "change", "change", "parent", "parent",
                    "change"):
            times[who].append(
                device_ms(fn_parent, key, lib_of=tree["build"])
                if who == "parent" else device_ms(fn_change, key))
        return {"ms_parent": sorted(times["parent"])[1],
                "ms_change": sorted(times["change"])[1],
                "ms_turns": times}

    def walk_populations():
        """{label: (scene, info, o, d, t_init)} of traverse_kernel's
        comparisons with another checkout: the terrain's 960,000 mixed rays
        (`query_rays`), and the cell terrain181.progressive's camera and
        third-bounce walks (`cell_walks`)."""
        return {"terrain_mixed": (terrain, terrain_info, *query_rays(
                    *terrain_cam, *forest_box(terrain), True)),
                **cell_walks()}

    def vs_tree(label, tree):
        """This checkout's kernels against another checkout's on the same
        inputs: outputs compared, device times in turns. Each library is
        compared where its sources differ, whatever the others do."""
        rec = {"phase": "parent_vs_change", "parent": label, "frame": {},
               "card": card}

        tf = tree["frame"]
        for n, refill, args, kw in (frame_cells() if differs(
                tree, build, "frame_kernel") else ()):
            out_p, out_c = tf.trace_frame(*args, **kw), frame.trace_frame(
                *args, **kw)
            cell = {"state_eq": float((out_p[1] == out_c[1]).float().mean()),
                    "radiance_eq": float((out_p[0] == out_c[0]).all(-1)
                                         .float().mean()),
                    "queries": [int(out_p[2]), int(out_c[2])],
                    **turns(tree, lambda: tf.trace_frame(*args, **kw),
                            lambda: frame.trace_frame(*args, **kw),
                            "frame_kernel")}
            if hasattr(tf, "phase_cycles"):
                cell["phases_parent"] = phase_shares(tf, args, kw)[1]
            name_ = f"{n} refill" if refill else str(n)
            rec["frame"][name_] = cell
            check(cell["state_eq"] >= 0.999 and cell["radiance_eq"] >= 0.999
                  and cell["queries"][0] == cell["queries"][1],
                  f"{label} against the change, frame {name_}: {cell}")
        tw = tree["wavefront"]
        # the walks also where only their wrapper differs (it chooses the
        # roots a launch walks)
        walks_differ = module_differs(tree, wavefront, "wavefront")
        if differs(tree, build, "forest_kernel") or walks_differ:
            # traverse_kernel on every walk population, bits equal on
            # every ray
            rec["traverse"] = {}
            for pop, (sc, info, o, d, t_init) in walk_populations().items():
                out_p = tw.trace_forest(o, d, t_init, sc, info)
                out_c = wavefront.trace_forest(o, d, t_init, sc, info)
                cell = {
                    "rays": int(t_init.shape[0]),
                    "live_rays": int((t_init > 0.0).sum()),
                    "equal": same_share(out_p, out_c, ("t", "u", "v", "idx",
                                                       "box", "leaf")),
                    **fetch_rounds(out_c[4], out_c[5], t_init > 0.0, info),
                    **turns(tree,
                            lambda o=o, d=d, t=t_init, sc=sc, info=info:
                            tw.trace_forest(o, d, t, sc, info),
                            lambda o=o, d=d, t=t_init, sc=sc, info=info:
                            wavefront.trace_forest(o, d, t, sc, info),
                            "traverse_kernel")}
                rec["traverse"][pop] = cell
                check(min(cell["equal"].values()) == 1.0,
                      f"{label} against the change, traverse {pop}: {cell}")
            # brute_kernel: the OBJ grid's 480,000 primary rays (the main
            # path's batch) and 960,000 mixed ones
            rec["brute"] = {}
            for pop, mixed in (("primary", False), ("mixed", True)):
                o, d, t_init = query_rays(*grid_cam, *forest_box(grid), mixed)
                out_p = tw.trace_forest(o, d, t_init, grid, grid_info)
                out_c = wavefront.trace_forest(o, d, t_init, grid, grid_info)
                dead = t_init == 0.0
                cell = {
                    "rays": int(t_init.shape[0]),
                    "equal": same_share(out_p, out_c, ("t", "u", "v", "idx",
                                                       "box", "leaf")),
                    "dead_exact": all(bool(torch.equal(a[dead], b[dead]))
                                      for a, b in zip(out_p, out_c)),
                    **turns(tree, lambda: tw.trace_forest(o, d, t_init, grid,
                                                    grid_info),
                            lambda: wavefront.trace_forest(o, d, t_init, grid,
                                                           grid_info),
                            "brute_kernel")}
                rec["brute"][pop] = cell
                check(min(cell["equal"].values()) >= 0.999
                      and cell["dead_exact"],
                      f"{label} against the change, brute {pop}: {cell}")
        if differs(tree, build, "block_kernel"):
            # one sample's rays of the OBJ grid (the main path's batch) and
            # of config 6 (four triangles)
            tb = tree["fused"]
            rec["block"] = {}
            for name_, (sc, info, cam, rot) in (
                    ("obj_grid", (grid, grid_info, *grid_cam)),
                    ("config6", (*scenes.BUILDERS[6]().build(device="cuda"),
                                 *scenes.CAMERAS[6]))):
                o, d, state = sample_rays(cam, rot, 800, 600)
                alive = torch.ones(state.shape, dtype=torch.bool, device=dev)

                def run(module, sc=sc, info=info, o=o, d=d, alive=alive,
                        state=state):
                    return module.trace_block(sc, info, o, d, alive, state,
                                              max_bounces=BOUNCES)

                out_p, out_c = run(tb), run(fused)
                cell = {
                    "rays": int(state.numel()),
                    "state_eq": float((out_p[1] == out_c[1]).float().mean()),
                    "radiance_eq": float((torch.stack(out_p[0]) == torch.stack(
                        out_c[0])).all(0).float().mean()),
                    "queries": [int(out_p[2]), int(out_c[2])],
                    **turns(tree, lambda: run(tb), lambda: run(fused),
                            "block_kernel")}
                if "check" in inspect.signature(tb.trace_block).parameters:
                    # the other checkout's lanes and cycles, where it can
                    lanes = tb.trace_block(sc, info, o, d, alive, state,
                                           max_bounces=BOUNCES,
                                           check="lanes")[3].tolist()
                    cyc = tb.trace_block(sc, info, o, d, alive, state,
                                         max_bounces=BOUNCES,
                                         check="phases")[3]
                    cell["lanes_busy_share_parent"] = (
                        lanes[0] / (32 * lanes[1]))
                    cell["phases_parent"] = {k: v / cyc["warp"]
                                             for k, v in cyc.items()
                                             if k != "warp"}
                rec["block"][name_] = cell
                check(cell["state_eq"] >= 0.999
                      and cell["radiance_eq"] >= 0.999,
                      f"{label} against the change, block {name_}: {cell}")
        if differs(tree, build, "streamed_kernel") or walks_differ:
            # the 1M terrain's primary and mixed rays, as given and sorted
            rec["streamed"] = {}
            for pop, (o, d, t_init) in streamed_pops.items():
                out_p = tw.trace_streamed(o, d, t_init, big, big_info)
                out_c = wavefront.trace_streamed(o, d, t_init, big, big_info)
                bits = torch.stack([(a == b) for a, b in
                                    zip(out_p, out_c)]).all(0)
                tp, tc = out_p[0][~bits], out_c[0][~bits]
                cell = {
                    "rays": int(t_init.shape[0]),
                    "equal": same_share(out_p, out_c, ("t", "u", "v", "idx",
                                                       "box", "rows")),
                    # t, u, v, idx, box and rows all bit-equal, and t on
                    # the other rays relative to 1 + t
                    "all_equal": float(bits.float().mean()),
                    "t_rel_err_rest": float(((tp - tc).abs()
                                             / (1.0 + tp.abs())).max())
                    if tp.numel() else 0.0,
                    **turns(tree, lambda: tw.trace_streamed(o, d, t_init, big,
                                                      big_info),
                            lambda: wavefront.trace_streamed(o, d, t_init,
                                                             big, big_info),
                            "streamed_kernel")}
                if hasattr(tw, "streamed_phase_cycles"):
                    cyc = tw.streamed_phase_cycles(o, d, t_init, big,
                                                   big_info)[-1]
                    cell["phases_parent"] = {
                        k: cyc[k] / cyc["warp"]
                        for k in ("top_box", "sub_box", "group", "stack")}
                    cell["distinct_groups_parent"] = (
                        cyc["group_distinct"] / max(cyc["group_tests"], 1))
                rec["streamed"][pop] = cell
                # the row cull changes which slots are tested, not the hit,
                # except where a row box's rounding differs from the slot
                # test's
                check(cell["all_equal"] >= 0.9999
                      and cell["t_rel_err_rest"] <= 1e-5,
                      f"{label} against the change, streamed {pop}: {cell}")
        if differs(tree, build, "mxu_group_kernel"):
            rec["group"] = {shape: group_vs_tree(label, tree, shape, data)
                            for shape, data in group_data.items()}
        if differs(tree, build, "mxu_group_kernel") or module_differs(
                tree, mm_probe, "mm_probe"):
            rec["probe"] = probe_vs_tree(label, tree)
        emit(rec, log)
        return rec

    # the group-test diagnostic's data: its own synthetic shape, and the
    # card's width on real data
    def wide_data():
        """The 1M terrain's 480,000 primary rays against the 32 groups of
        the treelet that most of their hits fall in, centred on its box."""
        o, d, _ = sample_rays(*big_cam, 800, 600)
        t_init = torch.full_like(o[0], 1e30)
        idx = wavefront.trace_streamed(o, d, t_init, big, big_info)[3]
        slots = lbvh.TREELET_ROWS * lbvh.TRIS_PER_ROW
        per_treelet = torch.bincount(idx[idx >= 0] // slots,
                                     minlength=big_info.st_n_treelets)
        treelet = int(per_treelet.argmax())
        box = big.st_top[big_info.st_n_treelets - 1 + treelet].cpu()
        return {"tris": big.st_tris[treelet * slots:(treelet + 1) * slots]
                .contiguous(), "o": tuple(o), "d": tuple(d),
                "center": ((box[0:3] + box[3:6]) / 2.0).tolist(),
                "treelet": treelet, "treelet_hits": int(per_treelet.max())}

    group_data = {"tool": diag_mxu.synthetic(GROUPS, 16, "cuda"),
                  "wide": wide_data()}
    # the tool's rays turned at its triangles: about half the rays hit,
    # where the shapes above have hits on one ray in twenty and one in fifty
    group_data["aimed"] = diag_mxu.aim(group_data["tool"])[0]
    emit({"phase": "scenes", "wide_treelet": group_data["wide"]["treelet"],
          "wide_treelet_hits": group_data["wide"]["treelet_hits"],
          "wide_center": group_data["wide"]["center"]}, log)

    def group_bound(n_rays, form=None, mm_only=False):
        """Least time of one pass of a group-test kernel over GROUPS groups:
        the largest of its bytes (rays in, hits out, the table once) over
        the memory rate, its product over the tensor cores' rate, and the
        float32 operations every slot or candidate surely needs over the
        CUDA cores' rate."""
        work = n_rays * GROUPS
        if form is None:        # vpu_kernel: 6 ray floats, t_init, triangles
            parts = {"bytes": n_rays * (28 + 16) + GROUPS * 56 * 36,
                     "tensor cores": 0.0,
                     "cuda cores": OPS_TRI_FREE * 56 * work / PEAK["f32"]}
        else:   # 16 features and t_init per ray; bf16 hi + lo are 4 bytes too
            passes, kind = FORM_PASSES[form]
            rate = PEAK[kind]
            padded = passes * OPS_PRODUCT_PADDED * work / rate
            parts = {"bytes": n_rays * (64 + 4 + 16) + GROUPS * 320 * 16 * 4,
                     "tensor cores": padded if mm_only
                     else passes * OPS_PRODUCT * work / rate,
                     "cuda cores": (OPS_MM_ONLY if mm_only
                                    else OPS_SIGN_TEST * 56)
                     * work / PEAK["f32"]}
        parts["bytes"] = parts["bytes"] / PEAK_BYTES
        unit = max(parts, key=parts.get)
        bound = {"bound_ms": 1e3 * parts[unit],
                 "bound_by": "bytes" if unit == "bytes" else "operations",
                 "bound_unit": unit,
                 "bound_parts_ms": {k: 1e3 * v for k, v in parts.items()}}
        if form is not None:
            bound["bound_parts_ms"]["padded product"] = 1e3 * padded
        return bound

    def prefilter_chunks(coef, feats):
        """The chunks of 8 triangles that prefilter_kernel's gate needs on
        this data, summed over the rays and GROUPS groups: a unit of
        GATE_RAYS rays leaves a group's gate at the first chunk where one
        of its rays has a plausible candidate (the plain version's
        products), and runs all 7 where none has."""
        ch, ca, fh, fa = mxu_group._bf16_tables(coef, feats)
        n, gate = feats.shape[1], mxu_group.GATE_RAYS
        units, chunks = -(-n // gate), mxu_tri.GROUP_TRIS // 8
        rays = torch.zeros(units * gate, device=feats.device)
        rays[:n] = 1.0
        rays = rays.view(units, gate).sum(1)
        total = 0
        for g in range(GROUPS):
            plaus = mxu_group._plausible(ch[g, :256] @ fh, ca[g, :256] @ fa)
            by_unit = torch.zeros(chunks, units * gate, dtype=torch.bool,
                                  device=feats.device)
            by_unit[:, :n] = plaus.view(chunks, 8, n).any(1)
            by_unit = by_unit.view(chunks, units, gate).any(2)
            ran = torch.where(by_unit.any(0),
                              by_unit.to(torch.int32).argmax(0) + 1, chunks)
            total += int((ran * rays).sum())
        return total

    def prefilter_bound(n_rays, passed_pairs, ray_chunks):
        """Least time of one pass of prefilter_kernel over GROUPS groups:
        bytes (rays in: re-centred origins, directions, t_init, features;
        hits out; the bf16 tables and the triangles once), the two bf16
        products and the margin test of the `ray_chunks` chunks the gate
        needs (`prefilter_chunks`), and the slot test of the rays of the
        units that passed (this run's counts)."""
        work = n_rays * GROUPS
        parts = {"bytes": (n_rays * (24 + 4 + 64 + 16)
                           + GROUPS * (2 * 320 * 16 * 2 + 56 * 36))
                 / PEAK_BYTES,
                 "tensor cores": OPS_E_PRODUCTS * ray_chunks / PEAK["bf16"],
                 "cuda cores": (OPS_MARGIN_TEST * 8 * ray_chunks
                                + OPS_TRI_FREE * 56 * 32 * passed_pairs)
                 / PEAK["f32"]}
        unit = max(parts, key=parts.get)
        return {"bound_ms": 1e3 * parts[unit],
                "bound_by": "bytes" if unit == "bytes" else "operations",
                "bound_unit": unit, "passed_pairs": passed_pairs,
                "gate_chunks_per_unit": ray_chunks / work,
                "bound_parts_ms": {k: 1e3 * v for k, v in parts.items()}}

    def plain_ms_of(fn):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        return out, a.elapsed_time(b)

    def share_of(ok, among):
        """The share of the rays `among` that are `ok`; 1 if there is none."""
        n = int(among.sum())
        return float((ok & among).sum()) / n if n else 1.0

    def form_parity(out_k, out_p):
        """Two (t, u, v, idx) of product forms: of the rays that hit in
        either, the share with idx equal and the share with idx equal and t
        within 1e-4 (1 + t) (few rays hit, so a share of all rays would
        hide a kernel that loses hits); the share of all rays with idx
        equal, the largest t error (relative to 1 + t, and absolute) where
        idx agrees on a hit, and whether the misses are exact."""
        same = out_k[3] == out_p[3]
        hit = same & (out_p[3] >= 0)
        either = (out_k[3] >= 0) | (out_p[3] >= 0)
        dt = (out_k[0] - out_p[0]).abs()[hit]
        rel = dt / (1.0 + out_p[0][hit].abs())
        good = same.clone()
        good[hit] = rel <= 1e-4
        return {"hits_idx_eq": share_of(same, either),
                "hits_idx_eq_and_t_within_1e-4": share_of(good, either),
                "idx_eq": float(same.float().mean()),
                "t_rel_err": float(rel.max()) if rel.numel() else 0.0,
                "max_abs_err": float(dt.max()) if dt.numel() else 0.0,
                "miss_exact": bool((out_k[0] == out_p[0])[same & ~hit].all()),
                "hit_share": float((out_k[3] >= 0).float().mean())}

    def scalar_parity(out_k, out_p):
        """Rows A and E: the share of the rays that hit in either with idx
        equal, of all rays, and the largest t, u, v difference where idx
        agrees."""
        same = out_k[3] == out_p[3]
        either = (out_k[3] >= 0) | (out_p[3] >= 0)
        return {"hits_idx_eq": share_of(same, either),
                "idx_eq": float(same.float().mean()),
                "max_abs_err": max(float((x - y).abs()[same].max())
                                   for x, y in zip(out_k[:3], out_p[:3])),
                "hit_share": float((out_k[3] >= 0).float().mean())}

    def against_a(out_a, out):
        """The tool's finding: a form against the scalar test."""
        both = (out_a[3] >= 0) & (out[3] >= 0)
        dt = (out_a[0] - out[0]).abs()[both]
        return {"idx_mismatch": float((out_a[3] != out[3]).float().mean()),
                "max_abs_dt": float(dt.max()) if dt.numel() else 0.0}

    def compare_group(shape, data):
        """Every group-test kernel against its plain version on `data`,
        one pass over GROUPS groups: {variant: record}."""
        tris, o, d, center = (data[k] for k in ("tris", "o", "d", "center"))
        n = o[0].shape[0]
        coef = mxu_tri.coef_table(tris[:GROUPS * mxu_tri.GROUP_TRIS], center)
        feats = mxu_tri.ray_features(o, d, center)
        t_init = torch.full((n,), 1e30, device=dev)
        zero = torch.zeros_like(t_init)
        kw = dict(n_groups=GROUPS, reps=1)
        recs, outs = {}, {}

        def record(variant, kernel, run, plain, bound, parity, limits):
            before = mxu_group.launches[kernel]
            out_k = run()
            torch.cuda.synchronize()
            check(mxu_group.launches[kernel] == before + 1,
                  f"{variant} did not launch {kernel}")
            out_p, plain_ms = plain_ms_of(plain)
            wrapper_ms, launch_ms = cuda_ms(run, 5), device_ms(run, kernel)
            rec = {"phase": "kernel_vs_plain", "kernel": kernel,
                   "variant": variant, "shape": shape, "rays": n,
                   "groups": GROUPS, **parity(out_k, out_p),
                   "finite": bool(torch.isfinite(out_k[0]).all()),
                   "ms": launch_ms if kernel in DEVICE_TIMED else wrapper_ms,
                   "wrapper_ms": wrapper_ms, "device_ms": launch_ms,
                   "plain_ms": plain_ms, **bound, "card": card}
            if variant != "A" and "mm_only" not in variant:
                rec["against_a"] = against_a(outs["A"], out_k)
            emit(rec, log)
            check(rec["finite"], f"{variant}: t not finite")
            for key, least_ok in limits.items():
                check(rec[key] >= least_ok, f"{variant} {shape}: {key} {rec}")
            recs[variant], outs[variant] = rec, out_k
            return rec

        rec = record("A", "vpu_kernel",
                     lambda: mxu_group.run_vpu(tris, o, d, t_init, **kw),
                     lambda: mxu_group.vpu_reference(tris, o, d, t_init, **kw),
                     group_bound(n), scalar_parity, {"hits_idx_eq": 0.999})
        check(rec["max_abs_err"] <= 1e-5, f"A {shape}: t, u, v {rec}")
        # idx equal on >= 99.5% of the rays that hit in either, and t
        # within 1e-4 (1 + t) on every ray with equal idx
        form_limits = {"hits_idx_eq": 0.995,
                       "hits_idx_eq_and_t_within_1e-4": 0.995}
        for precision in mxu_group.PRECISIONS:
            pkw = dict(precision=precision, **kw)
            for row, kernel, run in (("B", "mxu_kernel", mxu_group.run_mxu),
                                     ("C", "mxu_big_kernel",
                                      mxu_group.run_mxu_big)):
                rec = record(
                    f"{row} {precision}", kernel,
                    lambda: run(coef, feats, t_init, **pkw),
                    lambda: mxu_group.mxu_reference(coef, feats, t_init,
                                                    **pkw),
                    group_bound(n, precision), form_parity, form_limits)
                check(rec["miss_exact"] and rec["t_rel_err"] <= 1e-4,
                      f"{row} {precision}: t {rec}")
            b_vs_c = form_parity(outs[f"B {precision}"],
                                 outs[f"C {precision}"])
            emit({"phase": "kernel_vs_kernel", "pair": f"B, C {precision}",
                  "shape": shape, **b_vs_c}, log)
            check(all(b_vs_c[k] >= v for k, v in form_limits.items())
                  and b_vs_c["t_rel_err"] <= 1e-4,
                  f"B against C {precision}: {b_vs_c}")

            def mm_parity(out_k, out_p, precision=precision):
                c, f = (mxu_group._rounded(x, precision)
                        for x in (coef, feats))
                mag = sum(c[g, 0].abs() @ f.abs() for g in range(GROUPS))
                err = (out_k[0] - out_p[0]).abs()
                return {"err_over_magnitudes": float((err / mag).max()),
                        "max_abs_err": float(err.max()),
                        "untouched": bool((out_k[3] == -1).all())}

            rec = record(
                f"C mm_only {precision}", "mxu_big_kernel",
                lambda: mxu_group.run_mxu_big(coef, feats, zero,
                                              mm_only=True, **pkw),
                lambda: mxu_group.mm_only_reference(coef, feats, zero, **pkw),
                group_bound(n, precision, mm_only=True), mm_parity, {})
            check(rec["err_over_magnitudes"] <= 1e-5 and rec["untouched"],
                  f"C mm_only {precision}: {rec}")
        rec = record("D", "mxu_split3_kernel",
                     lambda: mxu_group.run_mxu_split3(coef, feats, t_init,
                                                      **kw),
                     lambda: mxu_group.split3_reference(coef, feats, t_init,
                                                        **kw),
                     group_bound(n, "split3"), form_parity, form_limits)
        check(rec["miss_exact"] and rec["t_rel_err"] <= 1e-4, f"D: t {rec}")

        # row E: the scalar test on re-centred inputs behind the bf16 gate
        tris_c = mxu_tri.recentre_tris(tris[:GROUPS * mxu_tri.GROUP_TRIS],
                                       center)
        o_c = mxu_tri.recentre_origins(o, center)

        def run_e():
            return mxu_group.run_prefilter(coef, tris_c, feats, o_c, d,
                                           t_init, **kw)

        passed = run_e()[4]
        hits_a = outs["A"][3] >= 0

        def prefilter_parity(out_k, out_p):
            return {**scalar_parity(out_k[:4], out_p[:4]),
                    "gate_eq": float((out_k[4] == out_p[4]).float().mean()),
                    "gate_pass_share": float(out_k[4].sum())
                    / (out_k[4].numel() * GROUPS),
                    "hits_of_a_lost": int((hits_a & (out_k[3] < 0)).sum()),
                    "margin_ratio": mxu_group.prefilter_margin(
                        coef, feats, outs["A"][3])}

        rec = record("E", "prefilter_kernel", run_e,
                     lambda: mxu_group.prefilter_reference(
                         coef, tris_c, feats, o_c, d, t_init, **kw),
                     prefilter_bound(n, int(passed.sum()),
                                     prefilter_chunks(coef, feats)),
                     prefilter_parity,
                     {"hits_idx_eq": 0.999, "gate_eq": 0.999})
        check(rec["max_abs_err"] <= 1e-5 and rec["hits_of_a_lost"] == 0
              and rec["margin_ratio"] > 0.0, f"E {shape}: {rec}")

        # the products themselves, on the first 16,384 rays: the kernels'
        # against the plain float32 product of the same (rounded or split)
        # operands, relative to the sum of magnitudes |coef| |feats|
        few = feats[:, :16384].contiguous()
        mag = (coef.abs() @ few.abs()).clamp(min=1e-30)
        for kernel, form in (("mxu_kernel", "highest"),
                             ("mxu_kernel", "default"),
                             ("mxu_big_kernel", "highest"),
                             ("mxu_big_kernel", "default"),
                             ("mxu_big_kernel", "split3")):
            got = mxu_group.mxu_candidates(coef, few, n_groups=GROUPS,
                                           precision=form, kernel=kernel)
            want = mxu_group.candidates_reference(coef, few, n_groups=GROUPS,
                                                  precision=form)
            exact = (coef.double() @ few.double()).float()
            rec = {"phase": "products", "form": form, "shape": shape,
                   "kernel": ("mxu_split3_kernel" if form == "split3"
                              else kernel),
                   "rays": int(few.shape[1]),
                   "err_over_magnitudes_x_2^20": float(
                       ((got - want).abs() / mag).max()) * 2.0 ** 20,
                   "kernel_vs_float64_x_2^20": float(
                       ((got - exact).abs() / mag).max()) * 2.0 ** 20,
                   "plain_vs_float64_x_2^20": float(
                       ((want - exact).abs() / mag).max()) * 2.0 ** 20}
            emit(rec, log)
            check(rec["err_over_magnitudes_x_2^20"] <= 1.0,
                  f"products {kernel} {form} {shape}: {rec}")
            del got, want, exact
        return recs, (coef, feats)

    group_recs = {shape: compare_group(shape, data)
                  for shape, data in group_data.items()}

    def group_nan(shape="aimed"):
        """The product forms on a table with NaN in one coefficient of the
        20 slots that win most often, four in each quantity: a NaN product
        fails the sign test (as jnp.minimum / jnp.maximum make it fail in
        the JAX reference), so none of those slots may win, in the kernel or
        in its plain version, and the two stay within the group-test parity
        limits."""
        coef, feats = group_recs[shape][1]
        t_init = torch.full((feats.shape[1],), 1e30, device=dev)
        kw = dict(n_groups=GROUPS, reps=1)
        clean = mxu_group.mxu_reference(coef, feats, t_init,
                                        precision="highest", **kw)
        wins = torch.bincount(clean[3][clean[3] >= 0],
                              minlength=GROUPS * mxu_tri.GROUP_TRIS)
        slots = wins.argsort(descending=True)[:20]
        poisoned = coef.clone()
        for k, s in enumerate(slots.tolist()):
            g, j = divmod(s, mxu_tri.GROUP_TRIS)
            poisoned[g, (k % 5) * mxu_tri.QUANT_PAD + j, k % 16] = float("nan")
        runs = {"D": (mxu_group.run_mxu_split3, mxu_group.split3_reference,
                      {})}
        for p in mxu_group.PRECISIONS:
            runs[f"B {p}"] = (mxu_group.run_mxu, mxu_group.mxu_reference,
                              {"precision": p})
            runs[f"C {p}"] = (mxu_group.run_mxu_big, mxu_group.mxu_reference,
                              {"precision": p})
        for variant, (run, plain, pkw) in runs.items():
            out_k = run(poisoned, feats, t_init, **kw, **pkw)
            out_p = plain(poisoned, feats, t_init, **kw, **pkw)
            rec = {"phase": "group_nan", "variant": variant, "shape": shape,
                   **form_parity(out_k, out_p),
                   "poisoned_slots_won_before": int(wins[slots].sum()),
                   "poisoned_slots_won_kernel": int(
                       torch.isin(out_k[3], slots).sum()),
                   "poisoned_slots_won_plain": int(
                       torch.isin(out_p[3], slots).sum()),
                   "card": card}
            emit(rec, log)
            check(rec["hits_idx_eq"] >= 0.995
                  and rec["hits_idx_eq_and_t_within_1e-4"] >= 0.995
                  and rec["miss_exact"] and rec["t_rel_err"] <= 1e-4
                  and rec["poisoned_slots_won_before"] > 0
                  and rec["poisoned_slots_won_kernel"] == 0
                  and rec["poisoned_slots_won_plain"] == 0,
                  f"NaN products, {variant} {shape}: {rec}")

    group_nan()

    def group_phase_shares(module, coef, feats, t_init, precision):
        """((t, u, v, idx), {part: share of the warps' cycles}) of one pass
        of `module`'s mxu_kernel through its check-only PHASES
        instantiation; "rest" is what no part covers."""
        *out, cyc = module.mxu_phase_cycles(coef, feats, t_init,
                                            n_groups=GROUPS, reps=1,
                                            precision=precision)
        shares = {k: cyc[k] / cyc["warp"]
                  for k in ("stage", "product", "test", "commit")}
        shares["rest"] = 1.0 - sum(shares.values())
        return out, shares

    # where mxu_kernel's warps' cycles go: the card's width and the aimed
    # rays (about half of them hit), both precisions
    group_phases_rec = {}
    for shape in ("wide", "aimed"):
        coef, feats = group_recs[shape][1]
        t_init = torch.full((feats.shape[1],), 1e30, device=dev)
        for precision in mxu_group.PRECISIONS:
            out, shares = group_phase_shares(mxu_group, coef, feats, t_init,
                                             precision)
            ref = mxu_group.run_mxu(coef, feats, t_init, n_groups=GROUPS,
                                    reps=1, precision=precision)
            rec = {"phase": "group_phases", "kernel": "mxu_kernel",
                   "shape": shape, "precision": precision,
                   "rays": int(t_init.shape[0]), "groups": GROUPS,
                   "shares": shares,
                   "same_outputs": all(bool(torch.equal(a, b))
                                       for a, b in zip(out, ref)),
                   "card": card}
            group_phases_rec[f"{shape} {precision}"] = rec
            emit(rec, log)
            check(rec["same_outputs"] and shares["rest"] > -0.01,
                  f"mxu_kernel PHASES {shape} {precision}: {rec}")

    def prefilter_phase_shares(module, args):
        """((t, u, v, idx, passed), {part: share of the warps' cycles}) of
        one pass of `module`'s prefilter_kernel through its check-only
        PHASES instantiation; "rest" is what no part covers."""
        *out, cyc = module.prefilter_phase_cycles(*args, n_groups=GROUPS,
                                                  reps=1)
        shares = {k: cyc[k] / cyc["warp"]
                  for k in ("stage", "product", "margin", "vote", "slot")}
        shares["rest"] = 1.0 - sum(shares.values())
        return out, shares

    def prefilter_args(shape):
        """Row E's inputs on one of the three populations: (coef, tris_c,
        feats, o_c, d, t_init), triangles and origins re-centred."""
        coef, feats = group_recs[shape][1]
        data = group_data[shape]
        return (coef, mxu_tri.recentre_tris(
                    data["tris"][:GROUPS * mxu_tri.GROUP_TRIS],
                    data["center"]), feats,
                mxu_tri.recentre_origins(data["o"], data["center"]),
                data["d"], torch.full((feats.shape[1],), 1e30, device=dev))

    # where prefilter_kernel's warps' cycles go, on all three populations
    for shape in group_data:
        args = prefilter_args(shape)
        out, shares = prefilter_phase_shares(mxu_group, args)
        ref = mxu_group.run_prefilter(*args, n_groups=GROUPS, reps=1)
        rec = {"phase": "group_phases", "kernel": "prefilter_kernel",
               "shape": shape, "rays": int(args[-1].shape[0]),
               "groups": GROUPS, "shares": shares,
               "same_outputs": all(bool(torch.equal(a, b))
                                   for a, b in zip(out, ref)),
               "card": card}
        group_phases_rec[f"E {shape}"] = rec
        emit(rec, log)
        check(rec["same_outputs"] and shares["rest"] > -0.01,
              f"prefilter_kernel PHASES {shape}: {rec}")

    def group_vs_tree(label, tree, shape, data):
        """Another checkout's group-test kernels against this one's on one
        of the three populations, one pass over GROUPS groups: at the
        group-test parity limits, and every output equal to the bit (each
        kernel keeps its arithmetic and its products' summation order):
        {variant: outputs compared, device times in turns}."""
        tg = tree["mxu_group"]
        tris, o, d, center = (data[k] for k in ("tris", "o", "d", "center"))
        coef = mxu_tri.coef_table(tris[:GROUPS * mxu_tri.GROUP_TRIS], center)
        feats = mxu_tri.ray_features(o, d, center)
        t_init = torch.full((o[0].shape[0],), 1e30, device=dev)
        zero = torch.zeros_like(t_init)
        tris_c = mxu_tri.recentre_tris(tris[:GROUPS * mxu_tri.GROUP_TRIS],
                                       center)
        o_c = mxu_tri.recentre_origins(o, center)
        kw = dict(n_groups=GROUPS, reps=1)
        runs = {"A": ("vpu_kernel",
                      lambda m: m.run_vpu(tris, o, d, t_init, **kw)),
                "E": ("prefilter_kernel",
                      lambda m: m.run_prefilter(coef, tris_c, feats, o_c, d,
                                                t_init, **kw)),
                "D": ("mxu_split3_kernel",
                      lambda m: m.run_mxu_split3(coef, feats, t_init, **kw))}
        for p in mxu_group.PRECISIONS:
            runs[f"B {p}"] = ("mxu_kernel", lambda m, p=p: m.run_mxu(
                coef, feats, t_init, precision=p, **kw))
            runs[f"C {p}"] = ("mxu_big_kernel", lambda m, p=p: m.run_mxu_big(
                coef, feats, t_init, precision=p, **kw))
            runs[f"C mm_only {p}"] = (
                "mxu_big_kernel", lambda m, p=p: m.run_mxu_big(
                    coef, feats, zero, precision=p, mm_only=True, **kw))
        cells = {}
        for variant, (kernel, run) in runs.items():
            out_p, out_c = run(tg), run(mxu_group)
            bits_equal = all(bool(torch.equal(a, b))
                             for a, b in zip(out_c, out_p))
            if variant in ("A", "E"):
                cell = scalar_parity(out_c[:4], out_p[:4])
                ok = (cell["hits_idx_eq"] >= 0.999
                      and cell["max_abs_err"] <= 1e-5)
                if variant == "E":
                    cell["gate_eq"] = float((out_c[4] == out_p[4]).float()
                                            .mean())
                    ok = ok and cell["gate_eq"] >= 0.999
                    if hasattr(tg, "prefilter_phase_cycles"):
                        cell["phases_parent"] = prefilter_phase_shares(
                            tg, (coef, tris_c, feats, o_c, d, t_init))[1]
            elif "mm_only" in variant:
                p = variant.split()[-1]
                c, f = (mxu_group._rounded(x, p) for x in (coef, feats))
                mag = sum(c[g, 0].abs() @ f.abs() for g in range(GROUPS))
                cell = {"err_over_magnitudes": float(
                    ((out_c[0] - out_p[0]).abs() / mag).max())}
                ok = cell["err_over_magnitudes"] <= 1e-5
            else:
                cell = form_parity(out_c, out_p)
                ok = (cell["hits_idx_eq"] >= 0.995
                      and cell["hits_idx_eq_and_t_within_1e-4"] >= 0.995
                      and cell["miss_exact"] and cell["t_rel_err"] <= 1e-4)
            cell["bits_equal"] = bits_equal
            ok = ok and bits_equal
            if variant.startswith("B "):
                p = variant.split()[-1]
                few = feats[:, :16384].contiguous()
                got, want = (m.mxu_candidates(coef, few, n_groups=GROUPS,
                                              precision=p,
                                              kernel="mxu_kernel")
                             for m in (mxu_group, tg))
                mag = (coef.abs() @ few.abs()).clamp(min=1e-30)
                cell["products_equal"] = bool(torch.equal(got, want))
                cell["products_err_over_magnitudes_x_2^20"] = float(
                    ((got - want).abs() / mag).max()) * 2.0 ** 20
                ok = ok and cell["products_err_over_magnitudes_x_2^20"] <= 1.0
                del got, want
                if hasattr(tg, "mxu_phase_cycles"):
                    cell["phases_parent"] = group_phase_shares(
                        tg, coef, feats, t_init, p)[1]
            cell.update(turns(tree, lambda: run(tg), lambda: run(mxu_group),
                              kernel))
            cells[variant] = cell
            check(ok, f"{label} against the change, {variant} {shape}: "
                      f"{cell}")
        return cells

    def library_products():
        """One PyTorch call for the product alone (what C `mm_only` prices)
        at the card's width: the (32, 320, 16) table times the (16, 480,000)
        features in float32, with TF32 allowed, and in bf16. It writes all
        32 x 320 x 480,000 products out, which no kernel here does."""
        coef, feats = group_recs["wide"][1]
        times = {}
        out = torch.empty((GROUPS, 320, feats.shape[1]), device=dev)
        times["float32"] = cuda_ms(lambda: torch.matmul(coef, feats, out=out),
                                   3)
        torch.backends.cuda.matmul.allow_tf32 = True
        times["tf32"] = cuda_ms(lambda: torch.matmul(coef, feats, out=out), 3)
        torch.backends.cuda.matmul.allow_tf32 = False
        del out
        c16, f16 = coef.bfloat16(), feats.bfloat16()
        out = torch.empty((GROUPS, 320, feats.shape[1]), device=dev,
                          dtype=torch.bfloat16)
        times["bf16"] = cuda_ms(lambda: torch.matmul(c16, f16, out=out), 3)
        del out
        torch.cuda.empty_cache()
        emit({"phase": "library", "call": "torch.matmul", "shape": "wide",
              "table": [GROUPS, 320, 16], "rays": int(feats.shape[1]),
              "library_ms": times, "card": card}, log)
        return times

    library_ms = library_products()

    def probe_vs_tree(label, tree):
        """Another checkout's mm_probe_kernel against this one's: every case
        of the tool at N = 1,024 and 480,000 and PROBE_CHECK_REPS reps, `o`
        equal to the bit and within 2^-20 of the sum of magnitudes of the
        plain version; device ms of one product and of PROBE_CHECK_REPS in
        turns, and their difference per product."""
        tp, cells = tree["mm_probe"], {}
        for n_cols in (PROBE_N, PROBE_WIDE_N):
            ops = diag_mxu_mm.operands(n_cols, "cuda")
            for form, precision, dtype in diag_mxu_mm.cases():
                a, b = ops[form.split("_")[0]].to(dtype), ops["b"].to(dtype)
                kw = dict(form=form, precision=precision)

                def run(module, reps, a=a, b=b, kw=kw):
                    return lambda: module.run(a, b, reps=reps, **kw)

                out_p = run(tp, PROBE_CHECK_REPS)()
                out_c = run(mm_probe, PROBE_CHECK_REPS)()
                want = mm_probe.mm_probe_reference(
                    a, b, reps=PROBE_CHECK_REPS, **kw)
                mag = mm_probe.magnitudes(a, b, reps=PROBE_CHECK_REPS,
                                          form=form)
                cell = {"bits_equal": bool(torch.equal(out_p, out_c)),
                        "err_over_magnitudes_x_2^20": float(
                            ((out_c.double() - want.double()).abs()
                             / mag).max()) * 2.0 ** 20,
                        **turns(tree, run(tp, 1), run(mm_probe, 1),
                                "mm_probe_kernel")}
                many = turns(tree, run(tp, PROBE_CHECK_REPS),
                             run(mm_probe, PROBE_CHECK_REPS),
                             "mm_probe_kernel")
                for who in ("parent", "change"):
                    cell[f"ms_check_reps_{who}"] = many[f"ms_{who}"]
                    cell[f"ms_per_product_{who}"] = (
                        (many[f"ms_{who}"] - cell[f"ms_{who}"])
                        / (PROBE_CHECK_REPS - 1))
                variant = f"{n_cols} {form} {precision} {str(dtype)[6:]}"
                cells[variant] = cell
                check(cell["bits_equal"]
                      and cell["err_over_magnitudes_x_2^20"] <= 1.0,
                      f"{label} against the change, probe {variant}: "
                      f"{cell}")
        return cells

    parent_recs = {label: vs_tree(label, tree) for label, tree in
                   trees.items()}

    def probe_bound(n_cols, reps, form, precision, dtype):
        """Least time of one launch of mm_probe_kernel: bytes (the slices
        of `a` it reads, b once, o out) or the `reps` whole products on the
        tensor cores (bf16 one pass, "highest" three TF32 passes); the 8
        rows the output needs are beside."""
        size = 2 if dtype == torch.bfloat16 else 4
        slices = min(reps, mm_probe.SLICES) if form.endswith("dyn") else 1
        passes, kind = FORM_PASSES[precision]
        rate = PEAK[kind]
        per_col = 2 * mm_probe.M * mm_probe.K * reps * passes
        parts = {"bytes": (slices * mm_probe.M * mm_probe.K * size
                           + mm_probe.K * n_cols * size + 8 * n_cols * 4)
                 / PEAK_BYTES,
                 "tensor cores": per_col * n_cols / rate}
        unit = max(parts, key=parts.get)
        return {"bound_ms": 1e3 * parts[unit],
                "bound_by": "bytes" if unit == "bytes" else "operations",
                "bound_unit": unit,
                "bound_parts_ms": {**{k: 1e3 * v for k, v in parts.items()},
                                   "8 rows": 1e3 * parts["tensor cores"] * 8
                                   / mm_probe.M}}

    def compare_probe(n_cols):
        """mm_probe_kernel against its plain version, every case of the
        tool, on its operands at `n_cols` columns: at PROBE_CHECK_REPS reps
        within 2^-20 of the sum of magnitudes |a| |b| (checked), and one
        launch of one product timed (device_ms, the wrapper's time beside)
        with its plain version and bound, and one of PROBE_CHECK_REPS
        products: their difference is the time of a product."""
        ops = diag_mxu_mm.operands(n_cols, "cuda")
        recs = {}
        for form, precision, dtype in diag_mxu_mm.cases():
            a, b = ops[form.split("_")[0]].to(dtype), ops["b"].to(dtype)
            kw = dict(form=form, precision=precision)
            before = mm_probe.launches["mm_probe_kernel"]
            got = mm_probe.run(a, b, reps=PROBE_CHECK_REPS, **kw)
            torch.cuda.synchronize()
            check(mm_probe.launches["mm_probe_kernel"] == before + 1,
                  "mm_probe.run did not launch its kernel")
            want = mm_probe.mm_probe_reference(a, b, reps=PROBE_CHECK_REPS,
                                               **kw)
            mag = mm_probe.magnitudes(a, b, reps=PROBE_CHECK_REPS, form=form)
            err = (got.double() - want.double()).abs()
            _, plain_ms = plain_ms_of(
                lambda: mm_probe.mm_probe_reference(a, b, reps=1, **kw))
            variant = f"{form} {precision} {str(dtype)[6:]}"

            def run(reps, a=a, b=b, kw=kw):
                return lambda: mm_probe.run(a, b, reps=reps, **kw)

            ms, ms_check = (device_ms(run(r), "mm_probe_kernel")
                            for r in (1, PROBE_CHECK_REPS))
            rec = {"phase": "kernel_vs_plain", "kernel": "mm_probe_kernel",
                   "variant": variant, "n": n_cols,
                   "check_reps": PROBE_CHECK_REPS,
                   "err_over_magnitudes_x_2^20": float((err / mag).max())
                   * 2.0 ** 20,
                   "max_abs_err": float(err.max()),
                   "finite": bool(torch.isfinite(got).all()),
                   "ms": ms, "ms_check_reps": ms_check,
                   "ms_per_product": (ms_check - ms)
                   / (PROBE_CHECK_REPS - 1),
                   "wrapper_ms": cuda_ms(run(1), 5),
                   "wrapper_ms_check_reps": cuda_ms(run(PROBE_CHECK_REPS),
                                                    5),
                   "plain_ms": plain_ms,
                   **probe_bound(n_cols, 1, form, precision, dtype),
                   "card": card}
            emit(rec, log)
            check(rec["finite"] and rec["err_over_magnitudes_x_2^20"] <= 1.0,
                  f"mm_probe {variant} at {n_cols}: {rec}")
            recs[variant] = rec
        # the library's figure: one torch.matmul of the whole product
        lib = {}
        for dtype in (torch.float32, torch.bfloat16):
            a = ops["std"][:mm_probe.M].to(dtype)
            b = ops["b"].to(dtype)
            out = torch.empty((mm_probe.M, n_cols), dtype=dtype, device=dev)
            lib[str(dtype)[6:]] = cuda_ms(
                lambda: torch.matmul(a, b, out=out), 5)
        emit({"phase": "library", "call": "torch.matmul", "shape": [
            mm_probe.M, mm_probe.K, n_cols], "library_ms": lib,
            "card": card}, log)
        return recs, lib

    probe_recs = {n_cols: compare_probe(n_cols)
                  for n_cols in (PROBE_N, PROBE_WIDE_N)}

    def zero_counts():
        frame.trace_frame.launches = 0
        frame.trace_frame.refill_launches = 0
        fused.trace_block.launches = 0
        bounce.bounce_step.launches = 0
        bounce.camera_step.launches = 0
        for counts in (wavefront.launches, mxu_group.launches,
                       mm_probe.launches):
            for k in counts:
                counts[k] = 0

    def timed_frames(r, n_frames):
        """Warm-up frame, then `n_frames` timed ones: (wall ms, CUDA ms,
        queries of the timed frames)."""
        r.step()
        torch.cuda.synchronize()
        q0 = r.rays_traced
        walls, events = [], []
        for _ in range(n_frames):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t = time.perf_counter()
            a.record()
            r.step()
            b.record()
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t))
            events.append(a.elapsed_time(b))
        return walls, events, r.rays_traced - q0

    # ---- 3. main paths at full size --------------------------------------
    zero_counts()
    main_rec = {}
    for n, (spp, raytracing) in MAIN.items():
        sc, info = scenes.BUILDERS[n]().build(device="cuda")
        cam, rot = scenes.CAMERAS[n]
        cfg = RenderConfig(width=800, height=600, samples_per_frame=spp,
                           max_bounces=BOUNCES, raytracing=raytracing,
                           auto_focus=True)
        r = Renderer(sc, info, cfg, cam_pos=cam, cam_rot=rot, seed=n,
                     device="cuda")
        before = frame.trace_frame.launches
        walls, events, queries = timed_frames(r, 2)
        img = r.display_image()
        rec = {"phase": "main_path", "config": n, "width": 800,
               "height": 600, "spp": spp, "bounces": BOUNCES,
               "whitted": not raytracing, "wall_ms": walls,
               "cuda_ms": events, "queries": queries,
               "mrays_per_s": queries / (sum(walls) / 1e3) / 1e6,
               **bound(sc, info, 800 * 600, queries // 2),
               "launches": frame.trace_frame.launches - before,
               "finite": bool(torch.isfinite(img).all()), "card": card}
        main_rec[n] = rec
        emit(rec, log)
        check(rec["finite"], f"config {n}: image not finite")
        check(rec["launches"] == 3, f"config {n}: launches {rec['launches']}")
    launches_main = frame.trace_frame.launches
    check(launches_main > 0 and frame.trace_frame.refill_launches == 0,
          "the main path never launched frame_kernel, or took the refill "
          "schedule unasked")

    # the refill schedule on the frame path: Renderer with PT0_FUSED_REFILL=1,
    # in turns with a Renderer of the default schedule on the same frames
    # (default, refill, refill, default), so both are timed on one card state
    zero_counts()

    def schedule_frames(r, refill):
        if refill:
            os.environ["PT0_FUSED_REFILL"] = "1"
        try:
            return timed_frames(r, 1)
        finally:
            os.environ.pop("PT0_FUSED_REFILL", None)

    for n, rec_refill in refill_full.items():
        spp = MAIN[n][0]
        sc, info = scenes.BUILDERS[n]().build(device="cuda")
        cam, rot = scenes.CAMERAS[n]
        cfg = RenderConfig(width=800, height=600, samples_per_frame=spp,
                           max_bounces=BOUNCES, auto_focus=True)
        runs = {k: Renderer(sc, info, cfg, cam_pos=cam, cam_rot=rot, seed=n,
                            device="cuda") for k in ("default", "refill")}
        turns = {"default": [], "refill": []}
        before = frame.trace_frame.refill_launches
        for schedule in ("default", "refill", "refill", "default"):
            turns[schedule].append(schedule_frames(runs[schedule],
                                                   schedule == "refill"))
        walls, events = ([t[i][0] for t in turns["refill"]] for i in (0, 1))
        queries = sum(t[2] for t in turns["refill"])
        img = runs["refill"].display_image()
        rec = {"phase": "main_path", "config": n, "schedule": "refill",
               "width": 800, "height": 600, "spp": spp, "bounces": BOUNCES,
               "wall_ms": walls, "cuda_ms": events, "queries": queries,
               "mrays_per_s": queries / (sum(walls) / 1e3) / 1e6,
               "default_schedule": {
                   "wall_ms": [t[0][0] for t in turns["default"]],
                   "cuda_ms": [t[1][0] for t in turns["default"]],
                   "queries": sum(t[2] for t in turns["default"])},
               "kernel_ms": {"refill": rec_refill["ms"],
                             "default": rec_refill["ms_default"]},
               "lane_use": {k: v["lane_use"]
                            for k, v in rec_refill["lanes"].items()},
               "ptxas": {k: v for k, v in ptxas.get("frame_kernel", {})
                         .items() if "ILb0E" in k},
               "launches": frame.trace_frame.refill_launches - before,
               "same_image": bool(torch.equal(
                   img, runs["default"].display_image())),
               "finite": bool(torch.isfinite(img).all()), "card": card}
        main_rec[f"{n}_refill"] = rec
        emit(rec, log)
        check(rec["finite"], f"config {n} refill: image not finite")
        # a warm-up and a timed frame in each of two turns
        check(rec["launches"] == 4, f"config {n} refill: launches {rec}")
        check(rec["default_schedule"]["queries"] == queries,
              f"config {n} refill: queries against the default {rec}")
    launches_refill = frame.trace_frame.refill_launches
    check(launches_refill > 0
          and frame.trace_frame.launches == 4 * len(refill_full),
          "PT0_FUSED_REFILL=1 did not take the refill schedule")

    # the per-bounce route: terrain through Renderer, OBJ grid through
    # Renderer (fused="off") and render_rays (fused="on")
    zero_counts()
    for raytracing in (True, False):
        cfg = RenderConfig(width=800, height=600,
                           samples_per_frame=TERRAIN_SPP,
                           max_bounces=BOUNCES, raytracing=raytracing,
                           auto_focus=True)
        r = Renderer(terrain, terrain_info, cfg, cam_pos=terrain_cam[0],
                     cam_rot=terrain_cam[1], seed=2, device="cuda")
        before = wavefront.launches["traverse_kernel"]
        before_b = bounce.bounce_step.launches
        before_c = bounce.camera_step.launches
        n_timed = 2 if raytracing else 1
        walls, events, queries = timed_frames(r, n_timed)
        img = r.display_image()
        sky = torch.tensor([0.5, 0.6, 0.9], device=dev)
        rec = {"phase": "main_path", "scene": "terrain",
               "tris": terrain_info.num_tris, "width": 800, "height": 600,
               "spp": TERRAIN_SPP, "bounces": BOUNCES,
               "whitted": not raytracing, "wall_ms": walls,
               "cuda_ms": events, "queries": queries,
               "mrays_per_s": queries / (sum(walls) / 1e3) / 1e6,
               "launches": wavefront.launches["traverse_kernel"] - before,
               "bounce_launches": bounce.bounce_step.launches - before_b,
               "camera_launches": bounce.camera_step.launches - before_c,
               "covered": float(((img - sky).abs().amax(-1) > 0.02)
                                .float().mean()),
               "finite": bool(torch.isfinite(img).all()), "card": card}
        main_rec["terrain_path" if raytracing else "terrain_whitted"] = rec
        emit(rec, log)
        check(rec["finite"], "terrain: image not finite")
        check(0.1 < rec["covered"] < 0.98, f"terrain: picture {rec}")
        # one bounce_kernel launch after each walk but the autofocus probe's
        # (one, in the warm-up frame); the camera form once a sample
        check(rec["launches"] >= (3 if raytracing else 2) * TERRAIN_SPP
              and rec["bounce_launches"] == rec["launches"] - 1
              and rec["camera_launches"] == (n_timed + 1) * TERRAIN_SPP,
              f"terrain: launches {rec}")
    gw, gh, gspp, gseed = GOLDEN
    grid_cfg = dict(max_bounces=BOUNCES, auto_focus=False,
                    focal_distance=5.0)
    grid_full = dict(width=800, height=600, samples_per_frame=TERRAIN_SPP,
                     **grid_cfg)
    grid_pose = [torch.tensor(v, dtype=torch.float32, device=dev)
                 for v in grid_cam]
    grid_ifd = torch.tensor(5.0, device=dev)

    class RaysRenderer:
        """`render_rays` over a whole frame behind Renderer's step(),
        rays_traced and display_image(), so both are driven alike."""

        def __init__(self, cfg):
            self.cfg, self.seed, self.queries = cfg, gseed, 0
            self.uv, self.index = camera.pixel_centers(cfg.width, cfg.height,
                                                       dev)

        def step(self):
            self.seed += 1
            self.image, q = render_rays(grid, grid_info, self.uv, self.index,
                                        *grid_pose, self.seed, grid_ifd,
                                        config=self.cfg)
            self.queries = self.queries + q

        @property
        def rays_traced(self):
            return int(self.queries)

        def display_image(self):
            return self.image.reshape(self.cfg.height, self.cfg.width, 3)

    grid_runs = (
        ("per_bounce", "brute_kernel",
         Renderer(grid, grid_info, RenderConfig(fused="off", **grid_full),
                  cam_pos=grid_cam[0], cam_rot=grid_cam[1], seed=3,
                  device="cuda"),
         lambda: wavefront.launches["brute_kernel"]),
        ("render_rays", "block_kernel",
         RaysRenderer(RenderConfig(fused="on", **grid_full)),
         lambda: fused.trace_block.launches))
    for label, kernel, r, launched in grid_runs:
        before_b = bounce.bounce_step.launches
        before_c = bounce.camera_step.launches
        walls, events, queries = timed_frames(r, 2)
        img, count = r.display_image(), launched()
        n_bounce = bounce.bounce_step.launches - before_b
        n_camera = bounce.camera_step.launches - before_c
        rec = {"phase": "main_path", "scene": "obj_grid", "route": label,
               "tris": grid_info.num_tris, "width": 800, "height": 600,
               "spp": TERRAIN_SPP, "bounces": BOUNCES, "wall_ms": walls,
               "cuda_ms": events, "queries": queries,
               "mrays_per_s": queries / (sum(walls) / 1e3) / 1e6,
               "kernel": kernel, "launches": count,
               "bounce_launches": n_bounce, "camera_launches": n_camera,
               "finite": bool(torch.isfinite(img).all()),
               "picture_std": float(img.clamp(0.0, 1.0).std()),
               "card": card}
        main_rec["grid_" + label] = rec
        emit(rec, log)
        check(rec["finite"], f"obj_grid {label}: image not finite")
        check(rec["picture_std"] > 0.05,
              f"obj_grid {label}: the grid is not in the picture")
        check(count >= 3 * TERRAIN_SPP, f"obj_grid {label}: launches {rec}")
        # the per-bounce route: one bounce_kernel launch after each walk;
        # the block path none
        check(n_bounce == (count if label == "per_bounce" else 0)
              and n_camera == 3 * TERRAIN_SPP,
              f"obj_grid {label}: bounce launches {rec}")
    launches_route = {"block_kernel": fused.trace_block.launches,
                      "bounce_kernel": bounce.bounce_step.launches,
                      CAMERA: bounce.camera_step.launches,
                      **wavefront.launches}
    check(launches_route.pop("streamed_kernel") == 0
          and launches_route.pop("sort_key_kernel") == 0,
          "the SAH scenes launched streamed_kernel")
    check(all(v > 0 for v in launches_route.values()),
          f"the per-bounce route missed a kernel: {launches_route}")
    check(frame.trace_frame.launches == 0,
          "the per-bounce route launched frame_kernel")

    # the streamed route: the 1M-triangle terrain through Renderer
    zero_counts()
    for raytracing in (True, False):
        cfg = RenderConfig(width=800, height=600, samples_per_frame=BIG_SPP,
                           max_bounces=BIG_BOUNCES, raytracing=raytracing,
                           auto_focus=False, blur=0.0)
        r = Renderer(big, big_info, cfg, cam_pos=big_cam[0],
                     cam_rot=big_cam[1], seed=5, device="cuda")
        before = wavefront.launches["streamed_kernel"]
        before_b = bounce.bounce_step.launches
        before_c = bounce.camera_step.launches
        n_timed = 2 if raytracing else 1
        walls, events, queries = timed_frames(r, n_timed)
        img = r.display_image()
        sky = torch.tensor([0.5, 0.6, 0.9], device=dev)
        rec = {"phase": "main_path", "scene": "terrain_1m",
               "tris": big_info.num_tris, "width": 800, "height": 600,
               "spp": BIG_SPP, "bounces": BIG_BOUNCES,
               "whitted": not raytracing, "wall_ms": walls,
               "cuda_ms": events, "queries": queries,
               "mrays_per_s": queries / (sum(walls) / 1e3) / 1e6,
               "launches": wavefront.launches["streamed_kernel"] - before,
               "bounce_launches": bounce.bounce_step.launches - before_b,
               "camera_launches": bounce.camera_step.launches - before_c,
               **big_seconds,
               "covered": float(((img - sky).abs().amax(-1) > 0.02)
                                .float().mean()),
               "finite": bool(torch.isfinite(img).all()), "card": card}
        main_rec["big_path" if raytracing else "big_whitted"] = rec
        emit(rec, log)
        check(rec["finite"], "terrain 1M: image not finite")
        check(0.1 < rec["covered"] < 0.98, f"terrain 1M: picture {rec}")
        # one launch per frame, sample and bounce
        check(rec["launches"] == (n_timed + 1) * BIG_SPP
              * (BIG_BOUNCES if raytracing else 1)
              and rec["bounce_launches"] == rec["launches"]
              and rec["camera_launches"] == (n_timed + 1) * BIG_SPP,
              f"terrain 1M: launches {rec}")
    launches_streamed = wavefront.launches["streamed_kernel"]
    launches_sort_key = wavefront.launches["sort_key_kernel"]
    launches_streamed_bounce = bounce.bounce_step.launches
    launches_streamed_camera = bounce.camera_step.launches
    # every query of the 480,000 rays is the ordered one
    check({k: v for k, v in wavefront.launches.items() if v}
          == {"streamed_kernel": launches_streamed,
              "sort_key_kernel": launches_sort_key}
          and launches_sort_key == launches_streamed
          and launches_streamed_bounce == launches_streamed
          and frame.trace_frame.launches == 0
          and fused.trace_block.launches == 0,
          f"the streamed route launched another kernel: {wavefront.launches}")

    # the diagnostic: the tool at its defaults and at the card's width
    zero_counts()
    tool_rows = {}
    for shape, kwargs in (("tool", {}),
                          ("wide", {"reps": GROUP_REPS_WIDE,
                                    "data": group_data["wide"]})):
        rows = diag_mxu.main(GROUPS, **kwargs, out=lambda line: None)
        tool_rows[shape] = rows
        emit({"phase": "main_path", "tool": "diag_mxu", "shape": shape,
              "rows": rows, "card": card}, log)
        check([r["row"][0] for r in rows] == list("ABCCBCCDE"),
              f"diag_mxu {shape}: rows {[r['row'] for r in rows]}")
        for r in rows:
            check(r["us_per_group_1024_rays"] > 0.0
                  and 2.5 < r["ms_4_reps"] / r["ms_reps"] < 5.5,
                  f"diag_mxu {shape}: 4 x reps against reps {r}")
        check(rows[-1]["hits_of_a_lost"] == 0
              and rows[-1]["idx_mismatch"] <= 0.001,
              f"diag_mxu {shape}: row E against A {rows[-1]}")
    check(tool_rows["tool"][0]["rays"] == 16384
          and tool_rows["wide"][0]["rays"] == 480000,
          "diag_mxu ran at other widths")
    launches_tool = dict(mxu_group.launches)
    check(all(v > 0 for v in launches_tool.values()),
          f"the diagnostic missed a kernel: {launches_tool}")
    check(not any(wavefront.launches.values())
          and frame.trace_frame.launches == 0
          and fused.trace_block.launches == 0
          and bounce.bounce_step.launches == 0
          and mm_probe.launches["mm_probe_kernel"] == 0,
          "the diagnostic launched a renderer kernel")

    # the small-K product probe: the tool at its defaults and at 480,000
    zero_counts()
    probe_rows = {}
    for n_cols, reps in ((PROBE_N, PROBE_REPS),
                         (PROBE_WIDE_N, PROBE_WIDE_REPS)):
        rows = diag_mxu_mm.main(n_cols, reps, device="cuda",
                                out=lambda line: None)
        probe_rows[n_cols] = rows
        emit({"phase": "main_path", "tool": "diag_mxu_mm", "n": n_cols,
              "reps": reps, "rows": rows, "card": card}, log)
        cases = [r for r in rows if r["form"] != "torch.matmul"]
        check(len(cases) == len(diag_mxu_mm.cases())
              and all(r["us_per_product"] > 0.0
                      and 2.5 < r["ms_4_reps"] / r["ms_reps"] < 5.5
                      for r in cases),
              f"diag_mxu_mm {n_cols}: 4 x reps against reps {cases}")
    launches_probe = mm_probe.launches["mm_probe_kernel"]
    check(launches_probe > 0 and not any(mxu_group.launches.values())
          and frame.trace_frame.launches == 0,
          "the probe missed its kernel or launched another")

    # ---- 4. routes against each other ------------------------------------
    route_cfg = RenderConfig(width=W_CMP, height=H_CMP,
                             samples_per_frame=SPP_CMP, max_bounces=BOUNCES,
                             auto_focus=False, focal_distance=20.0)

    def route_frame(trace, sc=terrain, info=terrain_info):
        """The terrain's frame as `render_rays` makes it, sample by
        sample, through `trace`: integrator.trace_bounces (the forest, or
        of the streamed build the LBVH, walked by the kernels) or
        trace_bounces_reference (their plain versions and the plain
        bounce step)."""
        cam, rot = (torch.tensor(v, dtype=torch.float32, device=dev)
                    for v in terrain_cam)
        uv, index = camera.pixel_centers(W_CMP, H_CMP, dev)
        rotmat = vm.rotation_matrix(rot)
        direction = camera.primary_directions(
            uv, rotmat, route_cfg.cam_size, route_cfg.focal_length,
            route_cfg.screen_h_ratio)
        state = vrng.seed(index, 4321)
        alive = torch.ones(state.shape, dtype=torch.bool, device=dev)
        total, queries = 0.0, 0
        for _ in range(SPP_CMP):
            o, d, state = camera.dof_ray(
                cam, direction, rotmat, route_cfg.blur,
                torch.tensor(20.0, device=dev), state)
            inc, skyc, state, q = trace(
                sc, info, o.unbind(-1), d.unbind(-1), alive, state,
                max_bounces=BOUNCES)
            total = total + torch.stack(
                [inc[i] + skyc[i] for i in range(3)], -1)
            queries += int(q.sum())
        return (total / SPP_CMP).reshape(H_CMP, W_CMP, 3), state, queries

    route_imgs = {}
    for label, sc, info in (("terrain", terrain, terrain_info),
                            ("terrain_streamed", terrain_st,
                             terrain_st_info)):
        img_k, st_k, q_k = route_frame(integrator.trace_bounces, sc, info)
        img_p, st_p, q_p = route_frame(integrator.trace_bounces_reference,
                                       sc, info)
        img_r, q_r = render_frame(sc, info, route_cfg, *terrain_cam, 4321,
                                  device="cuda")
        check(float((img_r - img_k).abs().max()) < 1e-6 and int(q_r) == q_k,
              f"{label}: render_frame and the sample-by-sample route "
              "disagree")
        diff = (img_k - img_p).abs().amax(-1)
        route_rec = {"phase": "route_vs_plain_route", "scene": label,
                     "shape": [W_CMP, H_CMP, SPP_CMP, BOUNCES],
                     "state_eq": float((st_k == st_p).float().mean()),
                     "frac_within_1e-4": float((diff < 1e-4).float().mean()),
                     "mean_abs": float((img_k - img_p).abs().mean()),
                     "queries_kernel": int(q_k), "queries_plain": int(q_p)}
        emit(route_rec, log)
        check(route_rec["state_eq"] >= 0.99, f"route: {route_rec}")
        check(route_rec["frac_within_1e-4"] >= 0.99, f"route: {route_rec}")
        check(route_rec["mean_abs"] < 5e-3, f"route: {route_rec}")
        check(abs(int(q_k) - int(q_p)) <= 0.01 * int(q_p) + 16,
              f"route: {route_rec}")
        route_imgs[label] = np.clip(img_k.cpu().numpy(), 0.0, 1.0)
    # the same terrain streamed against the SAH route
    err = img_util.rmse(route_imgs["terrain"], route_imgs["terrain_streamed"])
    emit({"phase": "routes", "scene": "terrain",
          "shape": [W_CMP, H_CMP, SPP_CMP, BOUNCES],
          "rmse": {"streamed_vs_sah": err}, "budget": 0.05}, log)
    check(err < 0.05, f"streamed route against the SAH route: RMSE {err}")
    grid_small = dict(width=gw, height=gh, samples_per_frame=gspp,
                      **grid_cfg)
    grid_frame, grid_off = (
        render_frame(grid, grid_info,
                     RenderConfig(fused=opt, **grid_small), *grid_cam,
                     gseed, device="cuda")[0] for opt in ("auto", "off"))
    uv, index = camera.pixel_centers(gw, gh, dev)
    grid_on, _ = render_rays(grid, grid_info, uv, index, *grid_pose, gseed,
                             grid_ifd,
                             config=RenderConfig(fused="on", **grid_small))
    imgs = {"block": grid_on.reshape(gh, gw, 3), "per_bounce": grid_off,
            "frame": grid_frame}
    imgs = {k: np.clip(v.cpu().numpy(), 0.0, 1.0) for k, v in imgs.items()}
    rmse = {f"{a}_vs_{b}": img_util.rmse(imgs[a], imgs[b])
            for a, b in (("block", "per_bounce"), ("block", "frame"),
                         ("per_bounce", "frame"))}
    emit({"phase": "routes", "scene": "obj_grid", "shape": list(GOLDEN[:3]),
          "rmse": rmse, "budget": 0.05,
          "picture_std": float(imgs["frame"].std())}, log)
    check(all(v < 0.05 for v in rmse.values()), f"routes disagree: {rmse}")
    check(imgs["frame"].std() > 0.05, "the OBJ grid is not in the picture")

    if "--profile" in sys.argv[1:]:
        profile_route(
            Renderer,
            RenderConfig(width=800, height=600,
                         samples_per_frame=TERRAIN_SPP, max_bounces=BOUNCES,
                         auto_focus=True),
            "terrain", terrain, terrain_info, terrain_cam, card, log)
        profile_route(
            Renderer,
            RenderConfig(width=800, height=600, samples_per_frame=BIG_SPP,
                         max_bounces=BIG_BOUNCES, auto_focus=False, blur=0.0),
            "terrain_1m", big, big_info, big_cam, card, log)

    # ---- 5. goldens ------------------------------------------------------
    for n in MAIN:
        sc, info = scenes.BUILDERS[n]().build(device="cuda")
        cam, rot = scenes.CAMERAS[n]
        cfg = RenderConfig(width=gw, height=gh, samples_per_frame=gspp,
                           max_bounces=BOUNCES, raytracing=n != 1,
                           auto_focus=False, blur=0.0)
        img, _ = render_frame(sc, info, cfg, cam, rot, gseed, device="cuda")
        golden = img_util.read_png(
            os.path.join(ROOT, "tests", "goldens", f"config{n}.png"))
        err = img_util.rmse(np.clip(img.cpu().numpy(), 0.0, 1.0), golden)
        emit({"phase": "golden", "config": n, "rmse": err, "budget": 0.05},
             log)
        check(err < 0.05, f"config {n}: golden RMSE {err}")

    # ---- 6. session: the user's surface of the renderer -------------------
    session_rec = session(torch, np, dev, card, log, zero_counts, scenes,
                          RenderConfig, Renderer, frame, wavefront,
                          {"config3": (*scenes.BUILDERS[3]().build(
                               device="cpu"), scenes.CAMERAS[3], {}),
                           "obj_grid": (*grid_cpu, grid_cam,
                                        {"fused": "off", **grid_cfg}),
                           "terrain_1m": (*big_host, big_cam,
                                          {"auto_focus": False})},
                          {"config3": scenes.BUILDERS[3]().build(
                               device="cuda"),
                           "obj_grid": (grid, grid_info),
                           "terrain_1m": (big, big_info)})

    # ---- 7. modes: the render modes off the frame path -------------------
    from types import SimpleNamespace

    modes(SimpleNamespace(
        torch=torch, np=np, dev=dev, size=(800, 600), small=GOLDEN[:2],
        card=card, log=log, zero_counts=zero_counts,
        RenderConfig=RenderConfig, Renderer=Renderer,
        render_frame=render_frame, render_rays=render_rays,
        autofocus_distance=autofocus_distance, camera=camera, vm=vm,
        frame=frame, wavefront=wavefront, bounce=bounce, img_util=img_util,
        terrain_scene=terrain_scene, grid_scene=grid_scene,
        grid_obj=grid_obj, terrain_cam=terrain_cam, grid_cam=grid_cam,
        big=big, big_info=big_info, big_host=big_host, big_cam=big_cam))

    # ---- 8, 9. obj and dist: the native OBJ parser, several devices -----
    def counts():
        """The launch counts that are not 0, by kernel."""
        return {k: v for k, v in {"frame_kernel": frame.trace_frame.launches,
                                  "block_kernel": fused.trace_block.launches,
                                  "bounce_kernel": bounce.bounce_step.launches,
                                  CAMERA: bounce.camera_step.launches,
                                  **wavefront.launches}.items() if v}

    slice_paths = SimpleNamespace(
        torch=torch, np=np, dev=dev, card=card, log=log,
        zero_counts=zero_counts, counts=counts, scenes=scenes, Scene=Scene,
        RenderConfig=RenderConfig, Renderer=Renderer, camera=camera,
        render_rays=render_rays, autofocus_distance=autofocus_distance,
        img_util=img_util, big=big, big_info=big_info, big_cam=big_cam,
        compare_streamed=compare_streamed)
    obj_phase(slice_paths)
    dist_phase(slice_paths, session_rec)

    # ---- 10. tools: the port's run tools at their full defaults ----------
    tools_phase(slice_paths, session_rec)

    # ---- 11. bounce: the per-bounce route's bounce kernel ----------------
    bounce_rec = bounce_phase(SimpleNamespace(
        **vars(slice_paths), size=(800, 600), terrain=terrain,
        terrain_info=terrain_info,
        terrain_cam=terrain_cam, grid=grid, grid_info=grid_info,
        grid_cam=grid_cam, sample_rays=sample_rays, least=least,
        timed_frames=timed_frames, wavefront=wavefront, vm=vm, vrng=vrng,
        frame=frame), trees)

    keys = ("shape", "timed_spp", "ms", "plain_ms", "bound_ms", "bound_by",
            "max_abs_err", "state_eq", "frac_within_1e-4",
            "timed_parity")
    kernels = {"kernels": [{
        "name": "frame_kernel", "route": "cuda",
        "source": "pathtracer0_tpu_torch/csrc/frame_kernel.cu",
        "replaces": "pathtracer0_tpu/kernels/fused.py:1498 _frame_kernel",
        "launches": launches_main,
        "max_abs_err": max(c["max_abs_err"] for c in full.values()),
        "ms": sum(c["ms"] for c in full.values()),
        "plain_ms": sum(c["plain_ms"] for c in full.values()),
        "bound_ms": sum(c["bound_ms"] for c in full.values()),
        "bound_by": max(full.values(),
                        key=lambda c: c["bound_ms"])["bound_by"],
        "library_ms": None,
        "state_eq": min(c["state_eq"] for c in full.values()),
        # launches x (time - bound), cell by cell
        "excess_ms": sum(main_rec[n]["launches"] * (c["ms"] - c["bound_ms"])
                         for n, c in full.items()),
        "per_config": {str(k): {key: c[key] for key in keys}
                       for k, c in full.items()},
        "per_config_320x240": {str(k): {key: c[key] for key in keys}
                               for k, c in small.items()},
        "phases": {k: r["shares"] for k, r in phases_rec.items()},
        "parents": {label: r["frame"] for label, r in parent_recs.items()},
    }] + [{
        "name": kname, "route": "cuda",
        "source": f"pathtracer0_tpu_torch/csrc/{src}", "replaces": replaces,
        "launches": count,
        **{key: rec[key] for key in ("max_abs_err", "ms", "plain_ms",
                                     "bound_ms", "bound_by")},
        "library_ms": None,
        "detail": {k: v for k, v in rec.items()
                   if k not in ("phase", "kernel", "card")},
        "parents": {label: r[kname.split("_")[0]]
                    for label, r in parent_recs.items()
                    if kname.split("_")[0] in r},
    } for kname, src, replaces, rec, count in (
        ("block_kernel", "block_kernel.cu",
         "pathtracer0_tpu/kernels/fused.py:1353 _fused_kernel", block_rec,
         launches_route["block_kernel"]),
        ("brute_kernel", "forest_kernel.cu",
         "pathtracer0_tpu/kernels/wavefront.py:64 _brute_kernel", brute_rec,
         launches_route["brute_kernel"]),
        ("traverse_kernel", "forest_kernel.cu",
         "pathtracer0_tpu/kernels/wavefront.py:562 _traverse_kernel",
         walk_rec, launches_route["traverse_kernel"]),
        ("streamed_kernel", "streamed_kernel.cu",
         "pathtracer0_tpu/kernels/wavefront.py:151 _streamed_kernel",
         streamed_rec, launches_streamed))]}
    # where block_kernel's warps' lanes and cycles go
    kernels["kernels"][1]["phases"] = {
        label: {**r["shares"], "rest": r["rest"],
                "lanes_busy_share": r["lanes_busy_share"]}
        for label, r in block_phases_rec.items()}
    # its two triangle loops by the scene's triangle count
    kernels["kernels"][1]["stage_min"] = {
        "STAGE_MIN": fused.STAGE_MIN,
        **{label: {k: r[k] for k in ("triangles", "ms_plain", "ms_staged")}
           for label, r in stage_min_rec.items()}}
    # streamed_kernel on every population, and where its warps' cycles go
    streamed_entry = kernels["kernels"][-1]
    streamed_entry["populations"] = {
        pop: {k: r[k] for k in ("ms", "wrapper_ms", "box_tests_per_live_ray",
                                "row_visits_per_live_ray", "key_ms",
                                "argsort_ms", "order_ms", "sort_ms")
              if k in r}
        for pop, r in streamed_recs.items()}
    streamed_entry["phases"] = {
        pop: {**r["shares"], "rest": r["rest"],
              **{k: r[k] for k in ("lanes_per_group_test",
                                   "distinct_groups_per_group_test",
                                   "rows_tested_per_group_entered",
                                   "row_boxes_per_group_entered")}}
        for pop, r in streamed_phases_rec.items()}
    # and against each --parent tree: device ms in turns, bits equal
    streamed_entry["ms_in_turns"] = {
        label: {pop: {"parent": c["ms_parent"], "change": c["ms_change"],
                      "all_equal": c["all_equal"]}
                for pop, c in r["streamed"].items()}
        for label, r in parent_recs.items() if "streamed" in r}
    # the group-test kernels: the card's width (480,000 rays, one pass over
    # 32 groups) on the line, the diagnostic's own shape and rows in `detail`
    def group_entry(kernel, replaces, main, variants):
        drop = ("phase", "kernel", "card", "shape")
        wide = group_recs["wide"][0]
        by_shape = {shape: {v: {k: x for k, x in recs[v].items()
                                if k not in drop} for v in variants}
                    for shape, (recs, _) in group_recs.items()}
        return {
            "name": kernel, "route": "cuda",
            "source": "pathtracer0_tpu_torch/csrc/mxu_group_kernel.cu",
            "replaces": f"tools/diag_mxu.py:{replaces}",
            "launches": launches_tool[kernel],
            "max_abs_err": max(wide[v]["max_abs_err"] for v in variants
                               if "mm_only" not in v),
            **{key: wide[main][key] for key in ("ms", "plain_ms", "bound_ms",
                                                "bound_by")},
            "library_ms": None,
            "detail": {
                "variant": main, **by_shape,
                "rows": {shape: [r for r in rows if r["row"][0] == main[0]]
                         for shape, rows in tool_rows.items()}},
            "parents": {label: {shape: {v: cells[v] for v in variants}
                                for shape, cells in r["group"].items()}
                        for label, r in parent_recs.items() if "group" in r}}

    kernels["kernels"] += [
        group_entry("vpu_kernel", "35 _vpu_kernel", "A", ("A",)),
        group_entry("mxu_kernel", "412 _mxu_kernel", "B default",
                    ("B default", "B highest")),
        group_entry("mxu_big_kernel", "105 _mxu_big_kernel", "C default",
                    ("C default", "C highest", "C mm_only default",
                     "C mm_only highest")),
        group_entry("mxu_split3_kernel", "170 _mxu_split3_kernel", "D",
                    ("D",))]
    # where mxu_kernel's warps' cycles go (its check-only PHASES)
    next(k for k in kernels["kernels"] if k["name"] == "mxu_kernel")[
        "phases"] = {cell: r["shares"] for cell, r in group_phases_rec.items()
                     if not cell.startswith("E ")}
    # one PyTorch call computes what the `mm_only` mode of mxu_big_kernel
    # does, the product alone: torch.matmul in float32, with TF32 allowed and
    # in bf16, beside the mode's own times; no call computes the full kernels
    big = kernels["kernels"][-2]
    big["library_ms"] = library_ms["bf16"]      # the entry is "default"
    big["library_of"] = {
        "mode": "mm_only", "torch.matmul_ms": library_ms,
        "mm_only_ms": {p: big["detail"]["wide"][f"C mm_only {p}"]["ms"]
                       for p in mxu_group.PRECISIONS}}
    # row E: the card's width on the line, as rows A-D, and where its
    # warps' cycles go on each population
    kernels["kernels"].append(
        group_entry("prefilter_kernel", "236 _prefilter_kernel", "E", ("E",)))
    kernels["kernels"][-1]["phases"] = {
        cell[2:]: r["shares"] for cell, r in group_phases_rec.items()
        if cell.startswith("E ")}
    # the refill schedule: cells 2, 4, 6 at the main path's 16 spp
    kernels["kernels"].append({
        "name": "frame_kernel_refill", "route": "cuda",
        "source": "pathtracer0_tpu_torch/csrc/frame_kernel.cu",
        "replaces": "pathtracer0_tpu/kernels/fused.py:1187 _frame_kernel "
                    "refill schedule (_trace_core, PT0_FUSED_REFILL)",
        "launches": launches_refill,
        "max_abs_err": max(c["max_abs_err"] for c in refill_full.values()),
        **{key: sum(c[key] for c in refill_full.values())
           for key in ("ms", "plain_ms", "bound_ms")},
        "bound_by": max(refill_full.values(),
                        key=lambda c: c["bound_ms"])["bound_by"],
        "library_ms": None,
        "excess_ms": sum(main_rec[f"{n}_refill"]["launches"]
                         * (c["ms"] - c["bound_ms"])
                         for n, c in refill_full.items()),
        "detail": {str(n): {k: v for k, v in c.items()
                            if k not in ("phase", "card")}
                   for n, c in refill_full.items()}})
    # the probe: one product (reps 1) of std_fix "default" at N = 480,000;
    # the library call multiplies the same product and writes all 320 rows
    probe_main = probe_recs[PROBE_WIDE_N][0]["std_fix default float32"]
    kernels["kernels"].append({
        "name": "mm_probe_kernel", "route": "cuda",
        "source": "pathtracer0_tpu_torch/csrc/mxu_group_kernel.cu",
        "replaces": "tools/diag_mxu_mm.py:19 _kernel",
        "launches": launches_probe,
        "max_abs_err": max(r["max_abs_err"] for recs, _ in probe_recs.values()
                           for r in recs.values()),
        **{key: probe_main[key] for key in ("ms", "plain_ms", "bound_ms",
                                            "bound_by")},
        "library_ms": probe_recs[PROBE_WIDE_N][1]["bfloat16"],
        "detail": {"variant": probe_main["variant"], "n": PROBE_WIDE_N,
                   "library_ms_all": {n: lib for n, (_, lib)
                                      in probe_recs.items()},
                   "cases": {n: {v: {k: x for k, x in r.items()
                                     if k not in ("phase", "kernel", "card")}
                                 for v, r in recs.items()}
                             for n, (recs, _) in probe_recs.items()},
                   "rows": probe_rows}})
    # bounce_kernel: the terrain's first bounce on the line (all its rays
    # alive, the route's largest batch), every cell and bounce in `detail`
    first = bounce_rec["path"]["terrain"][0]
    kernels["kernels"].append({
        "name": "bounce_kernel", "route": "cuda",
        "source": "pathtracer0_tpu_torch/csrc/bounce_kernel.cu",
        "replaces": "pathtracer0_tpu/render/integrator.py:180-287 (the "
                    "lax.while_loop body, XLA fusions; no Pallas kernel) "
                    "and :295 direct_diffuse",
        "launches": launches_route["bounce_kernel"] + launches_streamed_bounce,
        "max_abs_err": max(x["max_abs_err"] for cells in (
            *bounce_rec["path"].values(),
            [bounce_rec["whitted"][k] for k in bounce_rec["whitted"]])
            for x in cells),
        **{key: first[key] for key in ("ms", "plain_ms", "bound_ms",
                                       "bound_by")},
        "library_ms": None,
        "detail": {
            "path": bounce_rec["path"], "whitted": bounce_rec["whitted"],
            "frames": {name: {who: {k: x[k] for k in (
                "wall_ms", "cuda_ms", "busy_share", "device_kernels",
                "device_ops_per_bounce", "launches_per_frame")}
                for who, x in cell.items()}
                for name, cell in bounce_rec["frames"].items()},
            "deep_stacks": bounce_rec["deep_stacks"]}})
    # its camera form: the terrain's rays at the hero's blur, a later
    # sample (the first writes the sums instead of adding to them), every
    # cell and both blurs in `detail`
    cam_line = bounce_rec["camera"][f"terrain blur {HERO['blur']}"]
    kernels["kernels"].append({
        "name": CAMERA, "route": "cuda",
        "source": "pathtracer0_tpu_torch/csrc/bounce_kernel.cu",
        "replaces": "pathtracer0_tpu/core/camera.py:59 dof_ray and the "
                    "per-sample set-up of pathtracer0_tpu/render/"
                    "renderer.py:175-194 (XLA fusions in the jitted "
                    "fori_loop; no Pallas kernel)",
        "launches": launches_route[CAMERA] + launches_streamed_camera,
        "max_abs_err": max(x["max_abs_err"]
                           for x in bounce_rec["camera"].values()),
        **{key: cam_line[key] for key in ("ms", "plain_ms", "bound_ms",
                                          "bound_by")},
        "library_ms": None,
        "detail": bounce_rec["camera"]})
    # sort_key_kernel: the main path's batch, the camera's 480,000 primary
    # rays, on the line; both populations in `detail`
    key_recs = {pop: streamed_recs[f"{pop}_sorted"]
                for pop in ("primary", "mixed")}
    key_line = key_recs["primary"]
    kernels["kernels"].append({
        "name": "sort_key_kernel", "route": "cuda",
        "source": "pathtracer0_tpu_torch/csrc/streamed_kernel.cu",
        "replaces": "pathtracer0_tpu/kernels/traverse.py:410 "
                    "_spatial_sort_key and the key of :446 "
                    "_ray_scene_streamed(sort_rays=True) (XLA ops; no "
                    "Pallas kernel)",
        "launches": launches_sort_key,
        "max_abs_err": max(r["key_max_abs_err"] for r in key_recs.values()),
        "ms": key_line["sort_key_kernel_ms"],
        "plain_ms": key_line["plain_keys_ms"],
        **{key: key_line["sort_key_bound"][key]
           for key in ("bound_ms", "bound_by")},
        "library_ms": None,
        "detail": {pop: {k: r[k] for k in (
            "sort_key_kernel_ms", "plain_keys_ms", "sort_key_bound",
            "keys_equal", "nudged_equal", "key_max_abs_err",
            "query_ordered_ms", "query_torch_ms", "ordered_same_bits")}
            for pop, r in key_recs.items()}})
    # the order of work on the kernels: slower than the library's call for
    # the same function first, then the time above the bound over the
    # launches of the run (the frame entries sum ms and bound over cells,
    # so theirs is taken cell by cell above)
    for k in kernels["kernels"]:
        k["slower_than_library"] = (k["library_ms"] is not None
                                    and k["ms"] > k["library_ms"])
        k.setdefault("excess_ms", k["launches"] * (k["ms"] - k["bound_ms"]))
    check(len(kernels["kernels"]) == 15
          and all(k["launches"] > 0 for k in kernels["kernels"]),
          "a kernel of the paths was never launched")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"records": log, **kernels}, f, indent=1)
    # no time below its bound: that would make the bound no floor
    under = [(r.get("kernel", r.get("name")), r.get("variant", r.get("scene")),
              r["ms"], r["bound_ms"]) for r in log + kernels["kernels"]
             if "bound_ms" in r and "ms" in r and r["ms"] < r["bound_ms"]]
    check(not under, f"kernel times below their bounds: {under}")
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
