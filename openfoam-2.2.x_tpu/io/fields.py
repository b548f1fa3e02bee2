"""Field file reader/writer (0/U, 0/p, <time>/... in OpenFOAM format).

Reference: GeometricField I/O (src/OpenFOAM/fields/GeometricFields/) —
FoamFile header + dimensions + internalField + boundaryField. Output is
readable by reference tooling (paraFoam/foamLog interop, SURVEY.md §5.4).
"""

from __future__ import annotations

import gzip
import os
import re
from fractions import Fraction
from typing import Optional

import jax.numpy as jnp
import numpy as np

from ..bc import factory
from ..core.dictionary import FoamDict, Word, parse_file, parse_string
from ..core.dimensions import DimensionSet
from ..core.fields import VolField
from ..core.precision import scalar_np

# ---------------------------------------------------------------------------
# Binary format support (reference: src/OpenFOAM/db/IOstreams/, writeFormat
# binary): everything is ASCII except List<...> payloads, which are raw
# little-endian float64 between the parentheses.
# ---------------------------------------------------------------------------

_NCOMP = {"scalar": 1, "vector": 3, "symmTensor": 6, "tensor": 9, "label": 1}
_BLOB_RE = re.compile(rb"List<(scalar|vector|symmTensor|tensor)>\s*(\d+)\s*\(")


def _debinarize(raw: bytes):
    """Replace binary List payloads with placeholder words; returns
    (ascii_text, arrays)."""
    parts = []
    arrays = []
    i = 0
    while True:
        m = _BLOB_RE.search(raw, i)
        if not m:
            break
        kind = m.group(1).decode()
        n = int(m.group(2))
        nc = _NCOMP[kind]
        start = m.end()
        nbytes = n * nc * 8
        blob = raw[start:start + nbytes]
        arr = np.frombuffer(blob, dtype="<f8", count=n * nc)
        if nc > 1:
            arr = arr.reshape(n, nc)
        close = raw[start + nbytes:start + nbytes + 1]
        if close != b")":
            raise ValueError(
                f"binary List<{kind}> {n}: expected ')' after payload")
        parts.append(raw[i:m.start()].decode("latin-1"))
        idx = len(arrays)
        arrays.append(arr)
        parts.append(f"List<{kind}> {n} __BLOB{idx}__")
        i = start + nbytes + 1
    parts.append(raw[i:].decode("latin-1"))
    return "".join(parts), arrays


_BLOB_WORD = re.compile(r"__BLOB(\d+)__$")


def _subst_blobs(node, arrays):
    if isinstance(node, FoamDict):
        for k in list(node.keys()):
            node[k] = _subst_blobs(node[k], arrays)
        return node
    if isinstance(node, list):
        return [_subst_blobs(x, arrays) for x in node]
    if isinstance(node, (Word, str)):
        m = _BLOB_WORD.match(str(node))
        if m:
            return arrays[int(m.group(1))]
    return node


def load_field_dict(path: str) -> FoamDict:
    """parse_file that also understands `format binary` field files
    (plain or gzipped)."""
    if not os.path.exists(path) and os.path.exists(str(path) + ".gz"):
        path = str(path) + ".gz"
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rb") as f:
        raw = f.read()
    src_dir = os.path.dirname(os.path.abspath(path))
    if re.search(rb"format\s+binary", raw[:4096]):
        text, arrays = _debinarize(raw)
        d = parse_string(text, src_dir=src_dir)
        return _subst_blobs(d, arrays)
    text = raw.decode("latin-1")
    # fast path for big ASCII fields: cut the internalField list out of
    # the text and parse its numbers natively (native/foamtpu_io.cpp)
    # instead of tokenizing them through the dictionary parser
    if len(text) > 1 << 20:
        fast = _fast_internal_field(text)
        if fast is not None:
            text2, arr = fast
            d = parse_string(text2, src_dir=src_dir)
            from ..core.dictionary import Word as _Word

            d["internalField"] = [_Word("nonuniform"), arr]
            return d
    return parse_string(text, src_dir=src_dir)


_IF_RE = re.compile(
    r"internalField\s+nonuniform\s+List<(scalar|vector)>"
    r"\s*(\d+)\s*\(", re.S)


def _fast_internal_field(text):
    """-> (text with the internalField list replaced, np array) or
    None when the native parser is unavailable / format unexpected."""
    from . import native as native_io

    m = _IF_RE.search(text)
    if m is None:
        return None
    kind, n = m.group(1), int(m.group(2))
    per = 3 if kind == "vector" else 1
    got = native_io.parse_doubles_n(text[m.end():], n * per)
    if got is None:
        return None
    vals, off = got
    # the entry terminates at the first ';' after the list body
    end = text.find(";", m.end() + off)
    if end < 0:
        return None
    arr = vals.reshape(-1, 3) if per == 3 else vals
    return (text[:m.start()] + "internalField uniform 0;"
            + text[end + 1:], arr)


def read_field(path: str, mesh, name: Optional[str] = None) -> VolField:
    d = load_field_dict(path)
    name = name or os.path.basename(path)
    dims = d.get("dimensions", DimensionSet.of())
    if not isinstance(dims, DimensionSet):
        dims = DimensionSet.of()
    cls = str(d.get("FoamFile", {}).get("class", "volScalarField"))
    rank = 1 if "Vector" in cls else 0
    dtype = mesh.v.dtype

    internal = factory.parse_value(d["internalField"], mesh.n_cells, rank, dtype)
    if internal.ndim == 1 and rank == 1:
        internal = jnp.broadcast_to(internal[None, :], (mesh.n_cells, 3))

    bf = d["boundaryField"]
    bcs = []
    for p in mesh.patches:
        spec = bf.match(p.name)
        bcs.append(factory.from_dict(
            spec, p, rank, dtype, mesh=mesh,
            case_dir=os.path.dirname(os.path.dirname(
                os.path.abspath(path))),
            field_name=name))
    from ..bc.patchfields import normalize_bcs

    return VolField(data=internal, bcs=normalize_bcs(mesh, tuple(bcs), rank),
                    name=name, dims=dims)


_HEADER = """/*--------------------------------*- C++ -*----------------------------------*\\
| foamtpu: finite-volume framework on JAX/XLA | Version: 2.2.x                |
\\*---------------------------------------------------------------------------*/
FoamFile
{{
    version     2.0;
    format      {fmt};
    class       {cls};
    location    "{loc}";
    object      {obj};
}}
// * * * * * * * * * * * * * * * * * * * * * * * * * * * * * * * * * * * * * //

"""


def _list_parts(arr: np.ndarray, binary: bool):
    """`List<kind> N (payload)` as a list of str/bytes parts."""
    kind = "scalar" if arr.ndim == 1 else "vector"
    n = arr.shape[0]
    if binary:
        raw = np.ascontiguousarray(arr, dtype="<f8").tobytes()
        return [f"List<{kind}> {n}(", raw, ")"]
    if n > 20000:
        # vectorised %.17g formatting (round-trips exactly like repr)
        import io as _io

        buf = _io.StringIO()
        if arr.ndim == 1:
            np.savetxt(buf, arr, fmt="%.17g")
            body = buf.getvalue()
        else:
            np.savetxt(buf, arr, fmt="(%.17g %.17g %.17g)")
            body = buf.getvalue()
        return [f"List<{kind}>\n{n}\n(\n{body})"]
    if arr.ndim == 1:
        body = "\n".join(repr(float(x)) for x in arr)
    else:
        body = "\n".join(
            "(" + " ".join(repr(float(x)) for x in row) + ")" for row in arr
        )
    return [f"List<{kind}>\n{n}\n(\n{body}\n)"]


def _fmt_dims(dims: DimensionSet) -> str:
    def fmt(x: Fraction) -> str:
        return str(int(x)) if x.denominator == 1 else str(float(x))

    return "[" + " ".join(fmt(e) for e in dims.exponents()) + "]"


def _fmt_internal(data: np.ndarray, binary: bool = False):
    return (["internalField   nonuniform "]
            + _list_parts(data, binary) + [";\n"])


def _fmt_bvalue(vals: np.ndarray, binary: bool = False):
    if vals.ndim == 1:
        u = np.unique(np.round(vals, 12))
        if u.shape[0] == 1:
            return [f"uniform {repr(float(u[0]))}"]
    elif np.allclose(vals, vals[0:1], atol=0.0):
        return ["uniform (" + " ".join(repr(float(x)) for x in vals[0]) + ")"]
    return ["nonuniform "] + _list_parts(vals, binary) + ["\n"]


def write_field(field: VolField, mesh, case_dir: str, time_name: str,
                fmt: str = "ascii", compress: bool = False) -> str:
    """Write in OpenFOAM format under <case>/<time>/<name>.
    fmt: 'ascii' | 'binary' (controlDict writeFormat); compress: gzip
    (controlDict writeCompression) — both readable back by read_field
    and by reference tooling."""
    data = np.asarray(field.data)
    binary = fmt == "binary"
    cls = "volScalarField" if data.ndim == 1 else "volVectorField"
    out_dir = os.path.join(case_dir, time_name)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, field.name)

    parts = [_HEADER.format(fmt=fmt, cls=cls, loc=time_name, obj=field.name)]
    parts.append(f"dimensions      {_fmt_dims(field.dims)};\n\n")
    parts.extend(_fmt_internal(data, binary))
    parts.append("\nboundaryField\n{\n")
    from ..bc import patchfields as pf

    for p, bc in zip(mesh.patches, field.bcs):
        parts.append(f"    {p.name}\n    {{\n")
        kind = bc.kind
        out_type = {
            "fixedValue": "fixedValue",
            "zeroGradient": "zeroGradient",
            "empty": "empty",
            "symmetry": "symmetry",
            "symmetryPlane": "symmetryPlane",
            "slip": "slip",
            "calculated": "calculated",
            "mixed": "mixed",
            "fixedGradient": "fixedGradient",
            "inletOutlet": "inletOutlet",
        }.get(kind, kind)
        parts.append(f"        type            {out_type};\n")
        if kind in ("fixedValue", "calculated") or kind.endswith("WallFunction"):
            vals = np.asarray(pf.evaluate(bc, mesh, p, field.data))
            parts.append("        value           ")
            parts.extend(_fmt_bvalue(vals, binary))
            parts.append(";\n")
        elif kind == "inletOutlet":
            iv = np.asarray(
                jnp.broadcast_to(
                    jnp.asarray(bc.ref_value),
                    (p.size,) if data.ndim == 1 else (p.size, 3),
                )
            )
            parts.append("        inletValue      ")
            parts.extend(_fmt_bvalue(iv, binary))
            parts.append(";\n")
            vals = np.asarray(pf.evaluate(bc, mesh, p, field.data))
            parts.append("        value           ")
            parts.extend(_fmt_bvalue(vals, binary))
            parts.append(";\n")
        parts.append("    }\n")
    parts.append("}\n")
    blob = b"".join(
        x if isinstance(x, bytes) else x.encode("latin-1") for x in parts
    )
    if compress:
        path = path + ".gz"
        with gzip.open(path, "wb") as f:
            f.write(blob)
    else:
        with open(path, "wb") as f:
            f.write(blob)
    return path
