"""Parse LCM IDL (.lcm) files into LcmStructDef objects — lcm-gen's front end
(a copy of ``ocean_perception_tpu.fabric.lcm_gen``, on the port's ``lcm_types``).

The reference generates its bindings with lcm-gen at build time
(lcmtypes/CMakeLists.txt); users migrating with their own .lcm schemas can
load them directly:

    defs = parse_lcm_dir("my_lcmtypes/")          # {"pkg.type": LcmStructDef}
    bus.publish_lcm("chan", defs["pkg.foo_t"], {...})

Supported IDL subset (everything the reference's 16 schemas use, plus
consts): ``package``, ``struct`` with primitive/nested members, fixed and
variable array dimensions, ``const`` declarations (parsed and exposed,
not hashed — same as lcm-gen), ``//`` and ``/* */`` comments.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Tuple

from .lcm_types import PRIMITIVES, Dim, LcmStructDef, Member

_TOKEN = re.compile(
    # identifiers | hex | decimal with optional fraction/exponent (lcm-gen
    # parses double consts with strtod: "1.5e3", "1e-6" are legal) | punct
    r"[A-Za-z_][A-Za-z0-9_.]*|-?0[xX][0-9a-fA-F]+"
    r"|-?(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?|[{}\[\];=,]|\S"
)


def _strip_comments(text: str) -> str:
    text = re.sub(r"/\*.*?\*/", " ", text, flags=re.S)
    return re.sub(r"//[^\n]*", " ", text)


def parse_lcm_source(text: str) -> List[dict]:
    """Parse one .lcm file's text into raw struct descriptions:
    [{package, name, members: [(name, typename, dims)], consts: {...}}].
    Type references are left as names — resolve_structs links them."""
    toks = _TOKEN.findall(_strip_comments(text))
    i = 0
    package = ""
    out: List[dict] = []

    def expect(t: str) -> None:
        nonlocal i
        if i >= len(toks) or toks[i] != t:
            got = toks[i] if i < len(toks) else "<eof>"
            raise ValueError(f"LCM parse error: expected {t!r}, got {got!r}")
        i += 1

    while i < len(toks):
        tok = toks[i]
        if tok == "package":
            package = toks[i + 1]
            i += 2
            expect(";")
        elif tok == "struct":
            name = toks[i + 1]
            i += 2
            expect("{")
            members: List[Tuple[str, str, Tuple[Dim, ...]]] = []
            consts: Dict[str, object] = {}
            while True:
                if i >= len(toks):
                    raise ValueError(
                        f"LCM parse error: unterminated struct {name!r}"
                    )
                if toks[i] == "}":
                    break
                if toks[i] == "const":
                    # const int32_t FOO = 7, BAR = 9;
                    ctype = toks[i + 1]
                    i += 2
                    while True:
                        cname = toks[i]
                        expect_eq = toks[i + 1]
                        if expect_eq != "=":
                            raise ValueError("LCM parse error: const without =")
                        cval = toks[i + 2]
                        consts[cname] = (
                            float(cval) if ctype in ("float", "double")
                            else int(cval, 0)  # base 0: hex consts (0x10) too
                        )
                        i += 3
                        if toks[i] == ",":
                            i += 1
                            continue
                        expect(";")
                        break
                    continue
                mtype = toks[i]
                i += 1
                while True:  # double x, y, z;  — comma-separated declarators
                    mname = toks[i]
                    i += 1
                    dims: List[Dim] = []
                    while toks[i] == "[":
                        size = toks[i + 1]
                        if size.isdigit():
                            dims.append(("const", int(size)))
                        elif size in consts:
                            # lcm-gen resolves a const-name dimension to a
                            # CONST dim with the constant's value (the
                            # fingerprint hashes the value string) — "var"
                            # would both diverge from its hash and make
                            # encode() look up a nonexistent member.
                            dims.append(("const", int(consts[size])))
                        else:
                            dims.append(("var", size))
                        i += 2
                        expect("]")
                    members.append((mname, mtype, tuple(dims)))
                    if toks[i] == ",":
                        i += 1
                        continue
                    expect(";")
                    break
            i += 1  # consume }
            out.append(
                {"package": package, "name": name, "members": members, "consts": consts}
            )
        elif tok == ";":
            i += 1
        else:
            raise ValueError(f"LCM parse error: unexpected token {tok!r}")
    return out


def resolve_structs(raw: List[dict]) -> Dict[str, LcmStructDef]:
    """Link raw struct descriptions into LcmStructDefs. Unqualified nested
    type names resolve within the DECLARING package first (lcm-gen
    semantics), then as a globally unique short name; forward references
    allowed."""
    by_full: Dict[str, dict] = {}
    for r in raw:
        full = f"{r['package']}.{r['name']}"
        if full in by_full:
            raise ValueError(f"duplicate LCM type {full}")
        by_full[full] = r

    def lookup(mtype: str, pkg: str) -> dict | None:
        if "." in mtype:
            return by_full.get(mtype)
        same_pkg = by_full.get(f"{pkg}.{mtype}")
        if same_pkg is not None:
            return same_pkg
        matches = [r for r in raw if r["name"] == mtype]
        if len(matches) > 1:
            pkgs = sorted(r["package"] for r in matches)
            raise ValueError(
                f"ambiguous LCM type {mtype!r} (defined in packages {pkgs});"
                " qualify the reference"
            )
        return matches[0] if matches else None

    resolved: Dict[str, LcmStructDef] = {}

    def build(r: dict, stack: Tuple[str, ...]) -> LcmStructDef:
        full = f"{r['package']}.{r['name']}"
        if full in resolved:
            return resolved[full]
        if full in stack:
            raise ValueError(f"recursive LCM type {full} is not supported")
        members = []
        for mname, mtype, dims in r["members"]:
            target = None if mtype in PRIMITIVES else lookup(mtype, r["package"])
            if mtype in PRIMITIVES:
                members.append(Member(mname, mtype, dims))
            elif target is not None:
                members.append(Member(mname, build(target, stack + (full,)), dims))
            else:
                raise ValueError(f"unknown LCM type {mtype!r} in {full}")
        sd = LcmStructDef(r["package"], r["name"], tuple(members))
        resolved[full] = sd
        return sd

    for r in raw:
        build(r, ())
    # Return only fully-qualified keys.
    return {k: v for k, v in resolved.items() if "." in k}


def parse_lcm_dir(path: str) -> Dict[str, LcmStructDef]:
    """Parse every .lcm file under ``path`` into linked LcmStructDefs."""
    raw: List[dict] = []
    for fname in sorted(os.listdir(path)):
        if fname.endswith(".lcm"):
            with open(os.path.join(path, fname)) as f:
                raw.extend(parse_lcm_source(f.read()))
    return resolve_structs(raw)


def main(argv=None) -> int:
    """``python -m ocean_perception_tpu_torch.fabric.lcm_gen <dir>`` — list every
    parsed type with its wire fingerprint (compare against a peer's lcm-gen
    output when debugging interop)."""
    import argparse

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("path", help="directory of .lcm files")
    args = ap.parse_args(argv)
    for name, sd in sorted(parse_lcm_dir(args.path).items()):
        members = ", ".join(m.name for m in sd.members)
        print(f"{name:<40} 0x{sd.fingerprint().hex()}  ({members})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
