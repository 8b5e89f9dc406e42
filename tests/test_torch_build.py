"""The C interface of the CUDA kernels against its ctypes declarations.

``repro_torch.kernels._build`` loads every ``extern "C"`` function of
``csrc/*.cu`` through ``_SIGNATURES``; an argument missing or added on one
side goes unnoticed until the card crashes on the call.  These tests parse
the sources (no compiler, no JAX) and require the two to name the same
functions with the same number of arguments.
"""
import re

import pytest

from repro_torch.kernels import _build


def _strip_comments(src: str) -> str:
    src = re.sub(r"/\*.*?\*/", "", src, flags=re.S)
    return re.sub(r"//[^\n]*", "", src)


def _top_level_functions(body: str) -> dict:
    """name -> argument count of the function definitions at brace depth 0
    of ``body``."""
    out, depth, start = {}, 0, 0
    for i, ch in enumerate(body):
        if ch == "{":
            if depth == 0:
                m = re.search(r"(\w+)\s*\(([^()]*)\)\s*$", body[start:i])
                if m:
                    args = m.group(2).strip()
                    out[m.group(1)] = (0 if args in ("", "void")
                                       else args.count(",") + 1)
            depth += 1
        elif ch == "}":
            depth -= 1
            if depth == 0:
                start = i + 1
        elif ch == ";" and depth == 0:
            start = i + 1
    return out


def _block_end(src: str, open_brace: int) -> int:
    depth = 0
    for i in range(open_brace, len(src)):
        depth += {"{": 1, "}": -1}.get(src[i], 0)
        if depth == 0:
            return i
    raise ValueError("unbalanced braces")


def extern_c_functions(src: str) -> dict:
    """name -> argument count of every ``extern "C"`` function defined in a
    CUDA source: ``extern "C" int f(...) {`` and the functions of an
    ``extern "C" { ... }`` block."""
    src = _strip_comments(src)
    found = {}
    for m in re.finditer(r'extern\s+"C"\s*\{', src):
        end = _block_end(src, m.end() - 1)
        found.update(_top_level_functions(src[m.end():end]))
    one = r'extern\s+"C"\s+(?!\{)[^;{]*?(\w+)\s*\(([^()]*)\)\s*\{'
    for m in re.finditer(one, src):
        args = m.group(2).strip()
        found[m.group(1)] = 0 if args in ("", "void") else args.count(",") + 1
    return found


def _all_sources() -> dict:
    found = {}
    for path in _build.sources():
        for name, n in extern_c_functions(path.read_text()).items():
            assert name not in found, f"{name} defined twice"
            found[name] = (n, path.name)
    return found


def test_parser_reads_both_forms():
    src = '''
    // extern "C" int commented_out(int a);
    extern "C" const char* one(int code) { return 0; }
    namespace { int hidden(int a, int b) { return a; } }
    extern "C" {
    long long two(void) { return 1; }
    int three(const void* a, long long b,
              int c) { if (b) { return c; } return 0; }
    }  // extern "C"
    '''
    assert extern_c_functions(src) == {"one": 1, "two": 0, "three": 3}


@pytest.mark.parametrize("path", _build.sources(), ids=lambda p: p.name)
def test_every_extern_c_function_is_declared(path):
    for name, n in extern_c_functions(path.read_text()).items():
        assert name in _build._SIGNATURES, (
            f"{path.name}: {name} has no entry in _build._SIGNATURES")
        declared = len(_build._SIGNATURES[name][0])
        assert declared == n, (f"{path.name}: {name} takes {n} arguments, "
                               f"_SIGNATURES declares {declared}")


def test_every_declaration_has_a_definition():
    defined = _all_sources()
    missing = sorted(set(_build._SIGNATURES) - set(defined))
    assert not missing, f"declared in _SIGNATURES, defined nowhere: {missing}"
    for name, (args, _) in _build._SIGNATURES.items():
        assert len(args) == defined[name][0], name


def test_every_source_defines_an_entry_point():
    defined = _all_sources()
    files = {f for _, f in defined.values()}
    assert files == {p.name for p in _build.sources()}
