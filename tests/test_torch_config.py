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
