"""The port's own host front end (``eagle_mpc_tpu_torch.config``,
``dynamics.model``, ``dynamics.urdf``) against the JAX package's: every
robot under ``missions/`` with an MPC file, its hover mission, and the
flagship's displacement mission load to the same values, field by field
(exact equality: both parse the same files with the same numpy code), and
the flagship's offline reference reads back the same array."""

import dataclasses

import numpy as np
import pytest

from eagle_mpc_tpu.config import parser as jparser
from eagle_mpc_tpu.config import specs as jspecs
from eagle_mpc_tpu.dynamics import model as jmodel
from eagle_mpc_tpu_torch import config
from eagle_mpc_tpu_torch.config import parser
from eagle_mpc_tpu_torch.dynamics import model

from torch_port_util import DT_REF, FLAGSHIP, MISSIONS

ROBOTS = ("hexacopter370", "hexacopter370_flying_arm_3",
          "hexacopter680_flying_arm_2", "hextilt", "hextilt_flying_arm_5",
          "iris", "iris_px4")
MISSIONS_UNDER_TEST = [(r, "hover") for r in ROBOTS] + [(FLAGSHIP, "displacement")]

# each JAX class and the port's copy of it
TWINS = {jparser.ParamsServer: parser.ParamsServer,
         jmodel.RobotModel: model.RobotModel, jmodel.Frame: model.Frame}


def assert_same(want, got, path="value"):
    """Recursive field-by-field equality of a JAX-package value and the
    port's; classes must be twins (same name, the port's own module)."""
    if type(want) in TWINS or dataclasses.is_dataclass(want):
        assert type(got).__name__ == type(want).__name__, path
        assert type(got).__module__.startswith("eagle_mpc_tpu_torch."), path
        if isinstance(want, jparser.ParamsServer):
            assert_same(want._params, got._params, path + "._params")
            return
        for f in dataclasses.fields(want):
            assert_same(getattr(want, f.name), getattr(got, f.name),
                        f"{path}.{f.name}")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    elif isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            assert_same(want[k], got[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (w, g) in enumerate(zip(want, got)):
            assert_same(w, g, f"{path}[{i}]")
    else:
        assert type(got) is type(want) and got == want, (path, want, got)


@pytest.mark.parametrize("robot,mission", MISSIONS_UNDER_TEST)
def test_loaders_match_jax(robot, mission):
    traj = f"{robot}/trajectories/{mission}.yaml"
    assert_same(jspecs.load_trajectory(traj, yaml_dir=MISSIONS),
                config.load_trajectory(traj, yaml_dir=MISSIONS))
    if mission == "hover":
        mpc = f"{robot}/mpc/mpc.yaml"
        assert_same(jspecs.load_mpc_params(mpc, yaml_dir=MISSIONS),
                    config.load_mpc_params(mpc, yaml_dir=MISSIONS))


def test_missing_key_raises_the_same_exception():
    server = config.load_mpc_params(f"{FLAGSHIP}/mpc/mpc.yaml",
                                    yaml_dir=MISSIONS).server
    with pytest.raises(parser.MissingValueException):
        server.get_double("mpc_controller/no_such_key")
    assert issubclass(parser.MissingValueException, KeyError)


def test_load_ref_matches_tools():
    from tools.make_ref import load_ref, ref_path

    traj = config.load_trajectory(f"{FLAGSHIP}/trajectories/displacement.yaml",
                                  yaml_dir=MISSIONS)
    assert config.ref_path(FLAGSHIP, "displacement", DT_REF) == ref_path(
        FLAGSHIP, "displacement", DT_REF)
    for synthetic in (False, True):
        want, wkind = load_ref(FLAGSHIP, "displacement", DT_REF, traj=traj,
                               synthetic=synthetic)
        got, gkind = config.load_ref(FLAGSHIP, "displacement", DT_REF,
                                     traj=traj, synthetic=synthetic)
        assert gkind == wkind == ("synthetic" if synthetic else "offline")
        np.testing.assert_array_equal(got, want)


# the converter's strings of the JAX package's own codec tests
# (tests/test_config.py TestConverterCodecs): (function, argument, converter)
CONVERTER_CASES = [
    ("convert_matrix", "[1,2.5,-3]", None),
    ("convert_matrix", "[[2,3],1,2,3,4,5,6]", None),
    ("convert_matrix", "[[2,2],1,2,3]", None),          # raises
    ("convert_matrix", "[[1,3],7,8,9]", None),
    ("convert_pair", "{gain:2.5}", None),
    ("convert_pair", "{name:hexa}", str),
    ("convert_map", "[{kp:1.5},{kd:0.25}]", None),
    ("convert_map", "[kp:1.5]", None),                  # raises
    ("parse_list", "[a,[b,c],{d:e}]", None),
    ("to_string", np.arange(6.0).reshape(2, 3), None),
    ("to_string", {"a": 1.0, "b": -2.5}, None),
]


@pytest.mark.parametrize("fn,arg,conv", CONVERTER_CASES,
                         ids=[f"{f}-{i}" for i, (f, _, _) in
                              enumerate(CONVERTER_CASES)])
def test_converter_matches_jax(fn, arg, conv):
    """The port's converter gives the JAX converter's value, or raises its
    ValueError; a serialized value reads back the same in both."""
    from eagle_mpc_tpu.config import converter as jcvt
    from eagle_mpc_tpu_torch.config import converter as cvt

    args = (arg,) if conv is None else (arg, conv)
    try:
        want = getattr(jcvt, fn)(*args)
    except ValueError:
        with pytest.raises(ValueError):
            getattr(cvt, fn)(*args)
        return
    got = getattr(cvt, fn)(*args)
    assert_same(want, got)
    if fn == "to_string":
        back = "convert_map" if isinstance(arg, dict) else "convert_matrix"
        assert_same(getattr(jcvt, back)(want), getattr(cvt, back)(got))


def _servers(params):
    return jparser.ParamsServer(params), parser.ParamsServer(params)


@pytest.mark.parametrize("doc", [f"{FLAGSHIP}/trajectories/displacement.yaml",
                                 f"{FLAGSHIP}/mpc/mpc.yaml"])
def test_params_server_api_matches_jax(doc):
    """``has``, ``keys``, ``add_param`` and every typed getter on the
    flagship's YAML register, and ``get_matrix`` / ``get_map`` /
    ``get_pair`` on the reference's string forms, as the JAX package's."""
    path = f"{MISSIONS}/{doc}"
    js, ps = _servers(jparser.ParserYaml(path, yaml_dir=MISSIONS).get_params())
    assert_same(js, parser.ParamsServer(
        parser.ParserYaml(path, yaml_dir=MISSIONS).get_params()))
    assert ps.keys == js.keys and ps.keys
    assert not ps.has("no/such/key") and not js.has("no/such/key")
    for key in js.keys:
        assert ps.has(key) and js.has(key)
        value = js.get_raw(key)
        if isinstance(value, list) and value and all(
                isinstance(v, (int, float)) for v in value):
            assert_same(js.get_matrix(key), ps.get_matrix(key), key)
            assert_same(js.get_vector(key), ps.get_vector(key), key)
    for srv in (js, ps):
        srv.add_param("extra/value", 2.5)
        srv.add_param(js.keys[0], "not kept")    # the first value wins
    assert_same(js, ps)
    strings = {"mat": "[[2,2],1,2,3,4]", "vec": "[1,2,3]",
               "vec_dyn": "[[1,3],7,8,9]", "gains": "[{kp:10},{kd:2}]",
               "pair": "{mass:1.52}", "names": "{frame:gripper}",
               "yaml_map": {"kp": 3, "kd": "0.5"}}
    js, ps = _servers(strings)
    for key in ("mat", "vec", "vec_dyn"):
        assert_same(js.get_matrix(key), ps.get_matrix(key), key)
        assert_same(js.get_vector(key), ps.get_vector(key), key)
    for key in ("gains", "yaml_map"):
        assert_same(js.get_map(key), ps.get_map(key), key)
    assert_same(js.get_pair("pair"), ps.get_pair("pair"))
    assert_same(js.get_pair("names", str), ps.get_pair("names", str))
    with pytest.raises(parser.MissingValueException):
        ps.get_matrix("no/such/key")


@pytest.mark.parametrize("freely_parse", [False, True])
def test_parser_arguments_match_jax(freely_parse):
    """``ParserYaml(file, path_root, freely_parse)``: a file relative to
    ``path_root``, parsed by the schema or walked whole, gives the JAX
    parser's register."""
    root = f"{MISSIONS}/{FLAGSHIP}"
    for doc, top in (("trajectories/displacement.yaml", "trajectory"),
                     ("mpc/mpc.yaml", "mpc_controller")):
        kw = dict(path_root=root, freely_parse=freely_parse, yaml_dir=MISSIONS)
        want = jparser.ParserYaml(doc, **kw)
        got = parser.ParserYaml(doc, **kw)
        assert_same(want.get_params(), got.get_params(), doc)
        # a free walk keeps the document's top-level key in every path
        free = all(k.startswith(top + "/") for k in got.get_params())
        assert free == freely_parse, doc


@pytest.mark.parametrize("preset,kw", [
    ("hexarotor370_params", {}), ("hexarotor370_params", {"n_arm_joints": 3}),
    ("hexarotor680_params", {}),
    ("hexarotor680_params", {"n_arm_joints": 2, "arm_effort_limit": [2.0, 1.5]}),
])
def test_platform_presets_match_jax(preset, kw):
    """Both hexarotor presets build the same PlatformParams as the JAX
    package's, field by field (and are exported from ``utils``)."""
    from eagle_mpc_tpu import utils as jutils
    from eagle_mpc_tpu_torch import utils

    assert_same(getattr(jutils, preset)(**kw), getattr(utils, preset)(**kw))
