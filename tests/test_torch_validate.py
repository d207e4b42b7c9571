"""Build-time scene validation of the port (scene/validate.py) against the
JAX package's: the same scene, built with either package's Scene, raises
SceneValidationError with the same message in both, or builds in both.
The cases are tests/test_validate.py's and the malformed scenes that the
port once built without an error (a NaN triangle vertex, an inf mesh
vertex, a zero radius, a zero stretch, a zero implicit scale, a NaN
centre), plus an indexed mesh with a NaN vertex. CPU-sized: no render.
"""
import numpy as np
import pytest

from pathtracer0_tpu import Scene as JScene
from pathtracer0_tpu.scene.validate import \
    SceneValidationError as JSceneValidationError
from pathtracer0_tpu_torch import Scene as TScene
from pathtracer0_tpu_torch.scene.validate import SceneValidationError


def _base(cls):
    sc = cls()
    sc.set_constant_sky((0.5, 0.5, 0.5))
    sc.add_material("m")
    return sc


def _mesh_inf(sc):
    v2 = np.ones((2, 3))
    v2[1, 1] = np.inf
    sc.add_mesh(np.zeros((2, 3)), v2, np.ones((2, 3)) * 2, 0)


def _indexed_nan(sc):
    v = np.random.RandomState(0).rand(5, 3)
    v[2, 1] = np.nan
    sc.add_mesh_indexed(v, np.array([[0, 1, 2], [1, 2, 3], [2, 3, 4]]), 0)


def _bad_map(sc):
    sc.set_last_mtl("map_Kd", 7)  # no texture 7 registered
    sc.add_sphere((0, 0, 3), 1.0, m=0)


# name -> (what adds the scene's content, the message it must raise or None
# if it builds, whether the port's packing still refuses it unvalidated)
CASES = {
    # tests/test_validate.py
    "bad_material_index": (lambda sc: sc.add_sphere((0, 0, 3), 1.0, m=4),
                           "material 4", True),
    "nan_vertex": (lambda sc: sc.add_tri((0, 0, 3), (1, np.nan, 3),
                                         (0, 1, 3), 0), "non-finite", False),
    "nan_mesh_vertex": (_mesh_inf, "non-finite", False),
    "zero_radius_ellipsoid": (lambda sc: sc.add_ellipsoid(
        (0, 0, 3), (1, 1, 1), (0, 0, 0), 0.0, m=0), "radius", False),
    "bad_implicit_fn": (lambda sc: sc.add_implicit(
        11, (0, 0, 3), (1, 1, 1), (0, 0, 0), 0), "function id", False),
    "bad_map_index": (_bad_map, "map_Kd", True),
    "valid_scene_builds": (lambda sc: sc.add_sphere((0, 0, 3), 1.0, m=0),
                           None, False),
    "validation_can_be_skipped": (lambda sc: sc.add_sphere((0, 0, 3), 1.0,
                                                           m=0), None, False),
    # the malformed scenes the port built without an error
    "nan_triangle_vertex": (lambda sc: sc.add_tri(
        (0, np.nan, 3), (1, 0, 3), (0, 1, 3), 0), "non-finite", False),
    "inf_mesh_vertex": (_mesh_inf, "non-finite", False),
    "zero_radius_sphere": (lambda sc: sc.add_sphere((0, 0, 3), 0.0, m=0),
                           "radius", False),
    "zero_stretch_ellipsoid": (lambda sc: sc.add_ellipsoid(
        (0, 0, 3), (1, 0, 1), (0, 0, 0), 1.0, m=0), "stretch", False),
    "zero_scale_implicit": (lambda sc: sc.add_implicit(
        1, (0, 0, 3), (1, 1, 0), (0, 0, 0), 0), "scale", False),
    "nan_ellipsoid_centre": (lambda sc: sc.add_ellipsoid(
        (np.nan, 0, 3), (1, 1, 1), (0, 0, 0), 1.0, m=0), "non-finite", False),
    # the compact payload of an indexed mesh
    "indexed_mesh_nan_vertex": (_indexed_nan, "non-finite", False),
}


def _build(cls, name, **kw):
    sc = _base(cls)
    CASES[name][0](sc)
    if cls is TScene:
        kw["device"] = "cpu"
    return sc.build(**kw)


@pytest.mark.parametrize("name", sorted(CASES))
def test_validation_matches_jax(name):
    match = CASES[name][1]
    validate = name != "validation_can_be_skipped"
    if match is None:
        _build(JScene, name, validate=validate)
        scene, info = _build(TScene, name, validate=validate)
        assert info.num_ellipsoids == 1 and scene.ell_tab.shape[0] == 1
        return
    with pytest.raises(JSceneValidationError, match=match) as want:
        _build(JScene, name)
    with pytest.raises(SceneValidationError, match=match) as got:
        _build(TScene, name)
    assert isinstance(got.value, ValueError)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", sorted(k for k, v in CASES.items() if v[1]))
def test_validate_false_skips_the_checks(name):
    """validate=False builds what validation refuses, as the reference
    does; a material or map index past its table is still refused by the
    port's packing (a plain ValueError), the last guard before a kernel
    reads the tables without a bounds check."""
    _build(JScene, name, validate=False)
    if CASES[name][2]:
        with pytest.raises(ValueError) as err:
            _build(TScene, name, validate=False)
        assert not isinstance(err.value, SceneValidationError)
    else:
        _, info = _build(TScene, name, validate=False)
        assert info is not None
