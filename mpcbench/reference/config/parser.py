"""YAML mission/controller parser, schema-compatible with eagle-mpc.

The port's own copy of the JAX package's host-side parser (same keys, same
``MissingValueException``, same defaulting, the same ``ParamsServer`` API
with its codecs in ``converter``):

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
from typing import Any, Dict, List, Optional

import numpy as np
import yaml

from . import converter as cvt

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

#: Default search roots, overridable through the environment.
YAML_DIR = os.environ.get("EAGLE_MPC_TPU_YAML_DIR", os.path.join(_REPO_ROOT, "missions"))
ROBOT_DATA_DIR = os.environ.get("EAGLE_MPC_TPU_ROBOT_DIR", os.path.join(_REPO_ROOT, "robots"))


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
    """Flatten a trajectory / mpc_controller YAML into a register map.
    ``path_root`` prefixes a relative ``file``; ``freely_parse`` walks the
    whole document into the register, without the trajectory / controller
    schema."""

    def __init__(self, file: str, path_root: str = "", freely_parse: bool = False,
                 yaml_dir: Optional[str] = None):
        self._params: Dict[str, Any] = {}
        self._yaml_dir = yaml_dir or YAML_DIR
        path = file
        if path_root and not os.path.isabs(file):
            path = os.path.join(path_root, file)
        if freely_parse:
            self._walk(_load_yaml(path), "")
        else:
            self._parse(path)

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


class ParamsServer:
    """Typed access over the flat register. Raises ``MissingValueException``
    on absent keys so callers can default with try/except, as the
    reference's try/catch pattern does."""

    def __init__(self, params: Dict[str, Any]):
        self._params = dict(params)

    def add_param(self, key: str, value: Any):
        """Register ``value`` under ``key`` unless the key has one."""
        self._params.setdefault(key, value)

    def has(self, key: str) -> bool:
        return key in self._params

    @property
    def keys(self):
        return sorted(self._params)

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
            if s.startswith("[["):   # the dynamic Eigen form: its values
                return cvt.convert_matrix(s).ravel()
            v = yaml.safe_load(v)
        return np.asarray(v, dtype=np.float64)

    def get_matrix(self, key: str) -> np.ndarray:
        """The dynamic ``[[rows,cols],v...]`` form as a 2-D array, the flat
        ``[v...]`` form (or a YAML list) as it is."""
        v = self._get(key)
        if isinstance(v, str):
            return cvt.convert_matrix(v.replace(" ", ""))
        return np.asarray(v, dtype=np.float64)

    def get_map(self, key: str, conv=float) -> dict:
        """``[{id:value},...]`` (or a YAML mapping) as a dict."""
        v = self._get(key)
        if isinstance(v, dict):
            return {str(k): conv(val) for k, val in v.items()}
        return cvt.convert_map(str(v), conv)

    def get_pair(self, key: str, conv=float) -> tuple:
        """``{identifier:value}`` as (identifier, value)."""
        return cvt.convert_pair(str(self._get(key)), conv)

    def get_list(self, key: str) -> list:
        v = self._get(key)
        if isinstance(v, list):
            return v
        return list(yaml.safe_load(str(v)))

    def get_raw(self, key: str) -> Any:
        return self._get(key)
