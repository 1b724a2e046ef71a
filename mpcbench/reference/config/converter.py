"""String <-> typed-value codecs for the flat parameter register.

The port's own copy of the JAX package's ``config.converter`` (pure numpy
and ``re``), the Python analog of the reference's ``converter<T>`` template
family and its tokenizer (``include/eagle_mpc/utils/converter.hpp``,
``src/utils/converter_utils.cpp``):

- dynamic-size Eigen matrices ``[[rows,cols],v0,v1,...]`` and the flat
  ``[v0,v1,...]`` form (converter.hpp:208-239,
  splitMatrixStringRepresentation);
- ``std::pair`` ``{id:value}`` (converter.hpp:175-188);
- ``std::map<string,A>`` ``[{id:value},{id:value},...]``
  (converter.hpp:242-262);
- the serialization direction (converter<std::string>), so atomic ``$``
  maps round-trip.

All parsing is locale-independent (the reference's C++ ``stod`` is
locale-sensitive).
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Tuple

import numpy as np

_RGX_DYN_MATRIX = re.compile(
    r"\[\[((?:[0-9]+,?)+)\],((?:-?[0-9]*(?:\.[0-9]+)?(?:[eE][+-]?[0-9]+)?,?)+)\]")
_RGX_STATIC_MATRIX = re.compile(
    r"\[((?:(?:-?[0-9]*)(?:\.[0-9]+)?(?:[eE][+-]?[0-9]+)?,?)*)\]")
_RGX_PAIR = re.compile(r"\{([^\{:]+):([^\}]+)\}")
_RGX_MAP = re.compile(r"\[((?:(?:\{[^\{:]+:[^:\}]+\}),?)*)\]")


def parse_list(val: str) -> List[str]:
    """Bracket-aware top-level tokenizer (utils::parseList,
    converter_utils.cpp:79-135): splits ``[a,[b,c],{d:e}]`` into
    ``['a', '[b,c]', '{d:e}']``, preserving nested delimiters."""
    limiters: List[str] = []
    word_stack: List[str] = []
    current = ""
    words: List[str] = []
    for ch in val:
        if ch == "[" or ch == "{":
            limiters.append(ch)
            word_stack.append(current)
            current = ""
        elif ch == "]" or ch == "}":
            opener = "[" if ch == "]" else "{"
            if not limiters or limiters[-1] != opener:
                raise ValueError(f"Unmatched delimiter in {val!r}")
            if len(limiters) > 1:
                prev = word_stack.pop() if word_stack else ""
                current = prev + opener + current + ch
            elif opener == "{" or current != "":
                words.append(current)
                current = ""
            limiters.pop()
        elif ch == ",":
            if len(limiters) == 1 and current != "":
                words.append(current)
                current = ""
            elif len(limiters) > 1:
                current += ch
        else:
            if not limiters:
                raise ValueError(f"Found non-delimited text in {val!r}")
            current += ch
    if limiters:
        raise ValueError(f"Unclosed delimiter [] or {{}} in {val!r}")
    return words


def split_matrix_repr(val: str) -> Tuple[str, str]:
    """splitMatrixStringRepresentation (converter_utils.cpp:37-56):
    ``[[r,c],v...]`` -> ('[r,c]', '[v...]'); ``[v...]`` -> ('[]', '[v...]')."""
    val = val.replace(" ", "")
    m = _RGX_DYN_MATRIX.fullmatch(val)
    if m:
        return "[" + m.group(1) + "]", "[" + m.group(2) + "]"
    m = _RGX_STATIC_MATRIX.fullmatch(val)
    if m:
        return "[]", "[" + m.group(1) + "]"
    raise ValueError(
        "Invalid string representation of a Matrix. Correct format is "
        f"[([num,num],)?(num(,num)*)?]. String provided: {val}")


def convert_matrix(val: str) -> np.ndarray:
    """Eigen-matrix codec (converter.hpp:208-239): the dynamic two-part form
    returns a (rows, cols) array; the flat form returns a 1-D vector."""
    dims_s, vals_s = split_matrix_repr(val)
    vals = np.asarray([float(v) for v in vals_s[1:-1].split(",") if v != ""],
                      dtype=np.float64)
    if dims_s == "[]":
        return vals
    dims = [int(d) for d in dims_s[1:-1].split(",") if d != ""]
    if len(dims) != 2:
        raise ValueError(f"Missing dimensions in dynamic matrix: {val}")
    r, c = dims
    if r * c != vals.size:
        raise ValueError(
            f"The literal string provides {vals.size} values but the matrix "
            f"is of dimensions {r}x{c}")
    return vals.reshape(r, c)


def convert_pair(val: str, conv: Callable = float) -> Tuple[str, object]:
    """``{identifier:value}`` (converter.hpp:175-188)."""
    m = _RGX_PAIR.fullmatch(val.strip())
    if not m:
        raise ValueError(
            "Invalid string format representing a pair. Correct format is "
            f"{{identifier:value}}. String provided: {val}")
    return m.group(1).strip(), conv(m.group(2).strip())


def convert_map(val: str, conv: Callable = float) -> Dict[str, object]:
    """``[{id:value},...]`` (converter.hpp:242-262)."""
    compact = val.replace(" ", "")
    if not _RGX_MAP.fullmatch(compact):
        raise ValueError(
            "Invalid string representation of a Map. Correct format is "
            f"[({{id:value}})?(,{{id:value}})*]. String provided: {val}")
    out: Dict[str, object] = {}
    for item in parse_list(compact):
        k, v = convert_pair(item, conv)
        out[k] = v
    return out


def to_string(value) -> str:
    """Serialization direction (converter<std::string>, converter.hpp:100-171):
    scalars, sequences ``[a,b]``, pairs ``{k:v}``, maps ``[{k:v},...]`` and
    2-D arrays in the dynamic form ``[[r,c],v...]``."""
    if isinstance(value, (bool, np.bool_)):
        return "true" if value else "false"
    if isinstance(value, (int, np.integer)):
        return str(int(value))
    if isinstance(value, (float, np.floating)):
        return repr(float(value))
    if isinstance(value, str):
        return value
    if isinstance(value, tuple) and len(value) == 2 and isinstance(value[0], str):
        return "{" + value[0] + ":" + to_string(value[1]) + "}"
    if isinstance(value, dict):
        return "[" + ",".join("{" + k + ":" + to_string(v) + "}"
                              for k, v in value.items()) + "]"
    arr = np.asarray(value)
    if arr.ndim == 2:
        head = f"[{arr.shape[0]},{arr.shape[1]}]"
        body = ",".join(to_string(v) for v in arr.ravel())
        return "[" + head + ("," + body if body else "") + "]"
    if arr.ndim == 1:
        return "[" + ",".join(to_string(v) for v in arr.tolist()) + "]"
    return to_string(arr.item())
