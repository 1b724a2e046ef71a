"""YAML mission/controller parser, schema-compatible with eagle-mpc.

The port's own copy of the JAX package's host-side parser (same keys, same
``MissingValueException``, same defaulting), reduced to what the loaders in
``specs`` call:

- A file must start with ``trajectory:`` or ``mpc_controller:``.
- The result is a flat ``key/path -> value`` map ("register"):
  ``robot/...``, ``problem_params/...``, ``initial_state``, ``stages`` (list
  of stage descriptors), ``stages/<stage>/costs/<cost>/<field>``,
  ``stages/<stage>/contacts/<contact>/<field>``, ``mpc_controller/<key>``.
- A ``follow: <path>`` key inside any mapping loads the referenced YAML file
  into the SAME prefix (every robot file pulls in its platform this way).
  Relative paths resolve against the missions directory.
- Scalars beginning with ``@`` escape to a YAML file whose content replaces
  the node; keys beginning with ``$`` mark a node as atomic (kept whole).
- Duplicate keys keep the first value.

Values keep their native YAML types; ``ParamsServer`` converts on access.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional

import numpy as np
import yaml

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

#: Default search roots, overridable through the environment.
YAML_DIR = os.environ.get("EAGLE_MPC_TPU_YAML_DIR", os.path.join(_REPO_ROOT, "missions"))
ROBOT_DATA_DIR = os.environ.get("EAGLE_MPC_TPU_ROBOT_DIR", os.path.join(_REPO_ROOT, "robots"))

# the dynamic Eigen-matrix form "[[rows,cols],v0,v1,...]"
_RGX_DYN_MATRIX = re.compile(
    r"\[\[((?:[0-9]+,?)+)\],((?:-?[0-9]*(?:\.[0-9]+)?(?:[eE][+-]?[0-9]+)?,?)+)\]")


def get_yaml_path(path: str, yaml_dir: Optional[str] = None) -> str:
    if os.path.isabs(path):
        return path
    return os.path.join(yaml_dir or YAML_DIR, path)


def get_urdf_path(path: str, robot_dir: Optional[str] = None) -> str:
    if os.path.isabs(path):
        return path
    return os.path.join(robot_dir or ROBOT_DATA_DIR, path)


class MissingValueException(KeyError):
    pass


def _load_yaml(path: str) -> Any:
    with open(path) as f:
        return yaml.safe_load(f)


class ParserYaml:
    """Flatten a trajectory / mpc_controller YAML into a register map."""

    def __init__(self, file: str, yaml_dir: Optional[str] = None):
        self._params: Dict[str, Any] = {}
        self._yaml_dir = yaml_dir or YAML_DIR
        self._parse(file)

    def get_params(self) -> Dict[str, Any]:
        return self._params

    def _insert(self, key: str, value: Any):
        key = key.lstrip("/")
        if key in self._params:
            return  # first value wins
        self._params[key] = value

    def _parse(self, path: str):
        n = _load_yaml(path)
        if not isinstance(n, dict):
            raise ValueError(f"Empty or invalid YAML file: {path}")
        if "trajectory" in n and isinstance(n["trajectory"], dict):
            self._parse_trajectory(n["trajectory"], path)
        elif "mpc_controller" in n and isinstance(n["mpc_controller"], dict):
            self._parse_mpc(n["mpc_controller"])
        else:
            raise ValueError(
                f"Could not find neither a trajectory or an mpc_controller node in {path}; "
                "the file must start with 'trajectory:' or 'mpc_controller:'"
            )

    def _parse_trajectory(self, node: dict, path: str):
        if "robot" not in node or not isinstance(node["robot"], dict):
            raise ValueError(f"Missing 'robot' node in trajectory file {path}")
        self._walk(node["robot"], "robot")
        if isinstance(node.get("problem_params"), dict):
            self._walk(node["problem_params"], "problem_params")
        if "initial_state" in node and isinstance(node["initial_state"], list):
            self._insert("initial_state", node["initial_state"])
        stages = node.get("stages")
        if not stages:
            raise ValueError(f"Error parsing stages @ {path}: every stage needs a name, "
                             "duration and at least one cost")
        stage_descrs: List[Dict[str, Any]] = []
        for stage in stages:
            name = str(stage["name"])
            costs = stage.get("costs") or []
            contacts = stage.get("contacts") or []
            descr = {
                "name": name,
                "duration": stage["duration"],
                "transition": bool(stage.get("transition", False)),
                "costs": [str(c["name"]) for c in costs],
            }
            if contacts:
                descr["contacts"] = [str(c["name"]) for c in contacts]
            stage_descrs.append(descr)
            self._insert(f"stages/{name}/name", name)
            self._insert(f"stages/{name}/duration", stage["duration"])
            self._insert(f"stages/{name}/transition", descr["transition"])
            for cost in costs:
                self._walk(cost, f"stages/{name}/costs/{cost['name']}")
            for contact in contacts:
                self._walk(contact, f"stages/{name}/contacts/{contact['name']}")
        self._insert("stages", stage_descrs)

    def _parse_mpc(self, node: dict):
        for k, v in node.items():
            if k == "robot":
                self._walk(v, "robot")
            else:
                self._walk(v, f"mpc_controller/{k}")

    def _walk(self, node: Any, prefix: str):
        if isinstance(node, dict):
            for k, v in node.items():
                key = str(k)
                if key == "follow":
                    follow_path = get_yaml_path(str(v), self._yaml_dir)
                    self._walk(_load_yaml(follow_path), prefix)
                elif key.startswith("$"):
                    self._insert(f"{prefix}/{key[1:]}", v)
                else:
                    self._walk(v, f"{prefix}/{key}")
        elif isinstance(node, list):
            if not any(isinstance(x, dict) for x in node):   # atomic list
                self._insert(prefix, node)
            else:
                for item in node:
                    self._walk(item, prefix)
        elif isinstance(node, str) and node.startswith("@"):
            self._walk(_load_yaml(get_yaml_path(node[1:], self._yaml_dir)), prefix)
        elif node is None:
            pass
        else:
            self._insert(prefix, node)


def _dynamic_matrix_values(s: str) -> np.ndarray:
    """Values of ``[[rows,cols],v0,v1,...]`` in the given order, checked
    against rows x cols."""
    m = _RGX_DYN_MATRIX.fullmatch(s)
    if not m:
        raise ValueError(f"Invalid string representation of a Matrix: {s}")
    dims = [int(d) for d in m.group(1).split(",") if d != ""]
    vals = np.asarray([float(v) for v in m.group(2).split(",") if v != ""],
                      dtype=np.float64)
    if len(dims) != 2 or dims[0] * dims[1] != vals.size:
        raise ValueError(f"Matrix dimensions do not match its values: {s}")
    return vals


class ParamsServer:
    """Typed access over the flat register. Raises ``MissingValueException``
    on absent keys so callers can default with try/except, as the
    reference's try/catch pattern does."""

    def __init__(self, params: Dict[str, Any]):
        self._params = dict(params)

    def _get(self, key: str) -> Any:
        if key not in self._params:
            raise MissingValueException(
                f"The following key: '{key}' has not been found in the parameters server."
            )
        return self._params[key]

    def get_string(self, key: str) -> str:
        return str(self._get(key))

    def get_double(self, key: str) -> float:
        return float(self._get(key))

    def get_int(self, key: str) -> int:
        return int(float(self._get(key)))

    def get_bool(self, key: str) -> bool:
        v = self._get(key)
        if isinstance(v, bool):
            return v
        return str(v).strip().lower() in ("true", "1", "yes")

    def get_vector(self, key: str) -> np.ndarray:
        v = self._get(key)
        if isinstance(v, str):
            s = v.replace(" ", "")
            if s.startswith("[["):
                return _dynamic_matrix_values(s)
            v = yaml.safe_load(v)
        return np.asarray(v, dtype=np.float64)

    def get_list(self, key: str) -> list:
        v = self._get(key)
        if isinstance(v, list):
            return v
        return list(yaml.safe_load(str(v)))

    def get_raw(self, key: str) -> Any:
        return self._get(key)
