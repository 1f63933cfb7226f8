"""The port's public surface against the JAX package's, name for name.

For every module of ``src/repro`` (one case each), every public name it
defines or re-exports from the package must exist in its ``repro_torch``
counterpart.  For the classes and functions it defines, every public class
member and every named parameter must exist too.  Each gap must stand in
``NOT_PORTED`` with its reason.

A module's public names are its ``__all__`` where it has one, else the
names its top level binds (``def``, ``class``, assignments, and imports
from the package itself), less those starting with ``_`` and modules.
A class's members are the public names of its own and its package bases'
dicts, plus its dataclass or NamedTuple fields.  ``*args`` and
``**kwargs`` are not compared: no caller passes them by name.

Keys of ``NOT_PORTED``, relative to the package:

* ``mod.Name``: a module-level name;
* ``mod.Class.member``: a class member;
* ``mod.func(param=)``, ``mod.Class(param=)``, ``mod.Class.method(
  param=)``: a parameter;
* ``*.name``: that name, wherever it stands (module or class);
* ``*(param=)``: that parameter, wherever it stands.

The map cannot rot: each entry must still name something of the JAX
package, must still be a gap (a name ported since leaves the map), and
ROADMAP.md's "Deliberately not ported" list names the same keys.
"""
import ast
import dataclasses
import functools
import importlib
import inspect
import pathlib
import re

import pytest

pytestmark = pytest.mark.filterwarnings(
    "ignore:jax.experimental.shard_map is deprecated:DeprecationWarning")

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_SRC = ROOT / "src" / "repro"

_LEGACY = ("a deprecated alias that folds into a policy with identical "
           "results; the port takes the policy only")
_INCIDENTAL = ("an import the JAX module uses, not part of its API; the "
               "port's module does not need it")
_DTYPE = ("the JAX package's bfloat16 setting, which does not run there "
          "(its bf16 UNet fails in lax.conv_general_dilated on mixed "
          "dtypes), so there is no behaviour to port; the port's diffusion "
          "models compute in float32")
_BLOCK = ("a Pallas tile size; the CUDA kernels launch by their own rule "
          "or by the autotune table (KernelPolicy.tuned)")

NOT_PORTED = {
    # names that exist for Pallas, XLA or jax.random only
    "*(key=)": "a jax.random key; the port takes a torch.Generator or a "
               "seed",
    "*(interpret=)": "Pallas interpret mode; a wrapper on a CPU tensor "
                     "runs the plain version instead",
    "*(bk=)": "a Pallas key-block size; the CUDA kernels fix their key "
              "tile",
    "*(bm=)": "a Pallas row-block size of the bit-slice kernel",
    "*(bn=)": "a Pallas column-block size of the bit-slice kernel",
    "*(kv_len=)": "the unpadded length of Pallas-padded keys; the CUDA "
                  "kernels mask ragged edges themselves",
    "*(use_kernel=)": "the route follows the tensor's device: a CUDA tensor "
                      "launches the kernel, a CPU tensor takes its plain "
                      "version",
    "*.tree_flatten": "JAX pytree registration",
    "*.tree_unflatten": "JAX pytree registration",
    "*.resolve_interpret": "Pallas interpret-mode selection",
    "*.pad_axis_to": "Pallas block padding",
    "*.NEG_INF": "a Pallas kernel's mask constant",
    "kernels.runtime.COMPILING_BACKENDS": "Pallas interpret-mode selection",
    "kernels.runtime.default_interpret": "Pallas interpret-mode selection",
    "kernels.runtime.round_up": "Pallas block padding",
    "kernels.runtime.timed": "host wall-clock timing; the port times with "
                             "CUDA events (runtime.cuda_ms, min_ms)",
    "kernels.runtime.min_wall_s": "host wall-clock timing; the port times "
                                  "with CUDA events (runtime.cuda_ms, "
                                  "min_ms)",
    "kernels.dispatch.KernelPolicy.interpret": "Pallas interpret mode; "
                                               "--kernels interpret= raises",
    "kernels.dispatch.KernelPolicy.attn_block_q": _BLOCK,
    "kernels.dispatch.KernelPolicy.attn_block_k": _BLOCK,
    "kernels.dispatch.KernelPolicy.cross_block_q": _BLOCK,
    "kernels.dispatch.KernelPolicy.bitmap_block_rows": _BLOCK,
    "kernels.dispatch.KernelPolicy.reuse_block_patches": _BLOCK,
    "kernels.autotune.tune(backend=)": "a JAX backend name; the port sweeps "
                                       "on the card given by device=",
    "diffusion.sampler.sample_scan(policy_id=)": "a traced operand kept for "
                                                 "XLA's fusion",
    "launch.mesh.simulate_host_devices": "XLA host devices; the port's fake "
                                         "ranks are "
                                         "launch.mesh.fake_process_group",
    "launch.dryrun.force_fake_devices": "XLA host devices; the port's fake "
                                        "ranks are "
                                        "launch.mesh.fake_process_group",
    "launch.flops.count_jaxpr": "counts a jaxpr; flops.FlopCounter counts "
                                "the dispatched ops",
    "launch.dryrun.jaxpr_flops_cell": "counts a jaxpr; dryrun.flops_cell "
                                      "counts the dispatched ops",
    "launch.dryrun.collective_bytes_from_hlo": "reads XLA's HLO; "
                                               "parallel.collective_bytes "
                                               "records the collectives "
                                               "issued",
    # the deprecated aliases and their warning
    "core.policies.legacy_warning": "warns of the deprecated aliases, which "
                                    "the port does not have",
    "core.policies.LEGACY_WARNING_PREFIX": "warns of the deprecated "
                                           "aliases, which the port does "
                                           "not have",
    "diffusion.engine.legacy_warning": "warns of the deprecated aliases, "
                                       "which the port does not have",
    "diffusion.unet.UNetConfig.use_dbsc_kernel": _LEGACY,
    "diffusion.unet.UNetConfig.tips_threshold": _LEGACY,
    "diffusion.unet.UNetConfig.effective_kernel_policy": _LEGACY,
    "diffusion.unet.UNetConfig.effective_precision": _LEGACY,
    "diffusion.dit.DiTConfig.effective_kernel_policy": _LEGACY,
    "diffusion.dit.DiTConfig.effective_precision": _LEGACY,
    "diffusion.engine.DiffusionEngine(kernel_policy=)": _LEGACY,
    "diffusion.engine.DiffusionEngine(precision_policy=)": _LEGACY,
    "diffusion.engine.DiffusionEngine(reuse_policy=)": _LEGACY,
    "core.attention.cross_attention_tips(threshold=)": _LEGACY,
    "core.attention.cross_attention_tips(cls_index=)": _LEGACY,
    "core.attention.cross_attention_tips_fused(threshold=)": _LEGACY,
    "core.attention.cross_attention_tips_fused(cls_index=)": _LEGACY,
    "launch.cli.config_from_args(guidance=)": "the schedule's guidance "
                                              "comes from --guidance",
    "launch.cli.policies_from_args(clamp_reuse_capacity=)": "only a JAX "
        "test passes False; ServePolicies.parse gives the unclamped bundle",
    # fields nothing runs
    "diffusion.unet.UNetConfig.dtype": _DTYPE,
    "diffusion.vae.VAEConfig.dtype": _DTYPE,
    "diffusion.text_encoder.TextEncoderConfig.dtype": _DTYPE,
    "diffusion.dit.DiTConfig.dtype": _DTYPE,
    "diffusion.unet.UNetConfig.dbsc": "nothing in the JAX package reads "
                                      "it; DBSC is KernelPolicy.ffn",
    "diffusion.dit.DiTConfig.dbsc": "nothing in the JAX package reads it; "
                                    "DBSC is KernelPolicy.ffn",
    # incidental imports
    "diffusion.engine.init_text_encoder_params": _INCIDENTAL,
    "diffusion.engine.init_vae_params": _INCIDENTAL,
    "diffusion.engine.dp_axes_of": _INCIDENTAL,
    "diffusion.engine.dp_size_of": _INCIDENTAL,
    "diffusion.engine.mesh_signature": _INCIDENTAL,
    "kernels.cross_attention_tips.ops.cross_attention_tips_kernel":
        _INCIDENTAL,
    "kernels.pssa_attention.ops.pssa_attention_ref": _INCIDENTAL,
    "launch.dryrun.dp_axes_of": _INCIDENTAL,
    "launch.dryrun.make_production_mesh": _INCIDENTAL,
    "launch.dryrun.use_mesh": _INCIDENTAL,
    "launch.train.make_elastic_mesh": _INCIDENTAL,
    "models.moe.ShardCtx": _INCIDENTAL,
    "models.ssm.ShardCtx": _INCIDENTAL,
    "models.ssm.maybe_cs": _INCIDENTAL,
    "models.transformer.ShardCtx": _INCIDENTAL,
    "models.transformer.maybe_cs": _INCIDENTAL,
}


def _module_name(path: pathlib.Path) -> str:
    parts = path.relative_to(JAX_SRC.parent).with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


JAX_MODULES = sorted(_module_name(p) for p in JAX_SRC.rglob("*.py"))


def _bound_names(tree) -> list:
    """Names a module's top level binds, in order."""
    names = []

    def visit(body):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                names.append(node.name)
            elif isinstance(node, ast.Assign):
                names.extend(n.id for t in node.targets
                             for n in ast.walk(t) if isinstance(n, ast.Name))
            elif (isinstance(node, ast.AnnAssign)
                  and isinstance(node.target, ast.Name)):
                names.append(node.target.id)
            elif isinstance(node, ast.ImportFrom) and (
                    node.level or (node.module or "").split(".")[0]
                    == "repro"):
                names.extend(a.asname or a.name for a in node.names)
            elif isinstance(node, (ast.If, ast.Try)):
                visit(node.body)
                visit(node.orelse)
                for handler in getattr(node, "handlers", ()):
                    visit(handler.body)
    visit(tree.body)
    return names


def public_names(mod) -> list:
    if hasattr(mod, "__all__"):
        return list(mod.__all__)
    tree = ast.parse(pathlib.Path(mod.__file__).read_text())
    # a name bound only under ``if TYPE_CHECKING:`` is not on the module
    return [n for n in dict.fromkeys(_bound_names(tree))
            if not n.startswith("_") and hasattr(mod, n)
            and not inspect.ismodule(getattr(mod, n))]


def _fields(cls) -> set:
    names = set(getattr(cls, "_fields", ()))
    if dataclasses.is_dataclass(cls):
        names |= {f.name for f in dataclasses.fields(cls)}
    return names


def members(cls) -> list:
    names = set(_fields(cls))
    for base in cls.__mro__:
        if base.__module__.split(".")[0] == "repro":
            names |= {n for n in vars(base) if not n.startswith("_")}
    return sorted(n for n in names if not n.startswith("_"))


def has_member(cls, name) -> bool:
    return hasattr(cls, name) or name in _fields(cls)


def named_params(fn):
    """The parameters a caller can pass by name, or None where ``fn`` has
    no readable signature."""
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return None
    return [p.name for p in sig.parameters.values()
            if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)
            and p.name not in ("self", "cls")]


def _param_gaps(key, jfn, tfn) -> list:
    want = named_params(jfn)
    have = named_params(tfn)
    if not want or have is None:
        return []
    return [f"{key}({p}=)" for p in want if p not in have]


@functools.lru_cache(maxsize=None)
def module_gaps(name: str) -> tuple:
    """Every public name, member and parameter of JAX module ``name`` that
    its port lacks, as ``NOT_PORTED`` keys."""
    jmod = importlib.import_module(name)
    tmod = importlib.import_module("repro_torch" + name[len("repro"):])
    rel = name[len("repro."):]
    gaps = []
    for attr in public_names(jmod):
        key = f"{rel}.{attr}"
        if not hasattr(tmod, attr):
            gaps.append(key)
            continue
        jobj, tobj = getattr(jmod, attr), getattr(tmod, attr)
        if getattr(jobj, "__module__", None) != name:
            continue                     # checked where it is defined
        if inspect.isclass(jobj):
            for mem in members(jobj):
                if not has_member(tobj, mem):
                    gaps.append(f"{key}.{mem}")
                    continue
                jm = inspect.getattr_static(jobj, mem, None)
                if isinstance(jm, (staticmethod, classmethod)):
                    jm = jm.__func__
                if inspect.isfunction(jm):
                    gaps += _param_gaps(f"{key}.{mem}", jm,
                                        getattr(tobj, mem))
            if not dataclasses.is_dataclass(jobj):
                gaps += _param_gaps(key, jobj, tobj)
        elif callable(jobj):
            gaps += _param_gaps(key, jobj, tobj)
    return tuple(gaps)


def _wildcard(key: str):
    """``*.name`` -> ('.', name); ``*(param=)`` -> ('(', param)."""
    if key.startswith("*."):
        return ".", key[2:]
    m = re.fullmatch(r"\*\((\w+)=\)", key)
    return ("(", m.group(1)) if m else None


def excused_by(gap: str) -> list:
    out = []
    for key in NOT_PORTED:
        wild = _wildcard(key)
        if wild is None:
            hit = gap == key
        elif wild[0] == ".":
            hit = "(" not in gap and gap.endswith("." + wild[1])
        else:
            hit = gap.endswith(f"({wild[1]}=)")
        if hit:
            out.append(key)
    return out


def all_gaps() -> list:
    return [g for name in JAX_MODULES for g in module_gaps(name)]


@pytest.mark.parametrize("name", JAX_MODULES)
def test_module_surface_is_ported(name):
    unexcused = [g for g in module_gaps(name) if not excused_by(g)]
    assert not unexcused, (
        f"{name}: these public names have no counterpart in the port and "
        f"no NOT_PORTED entry: {unexcused}")


def _resolve_in_jax(key: str) -> bool:
    """Does ``key`` (not a wildcard) name something of the JAX package?"""
    path, param = re.fullmatch(r"([\w.]+?)(?:\((\w+)=\))?", key).groups()
    parts = path.split(".")
    cut = next((c for c in range(len(parts) - 1, 0, -1)
                if "repro." + ".".join(parts[:c]) in JAX_MODULES), None)
    if cut is None:
        return False
    obj = importlib.import_module("repro." + ".".join(parts[:cut]))
    rest = parts[cut:]
    for i, attr in enumerate(rest):
        if hasattr(obj, attr):
            obj = getattr(obj, attr)
        elif (i == len(rest) - 1 and param is None and inspect.isclass(obj)
              and attr in _fields(obj)):
            return True                  # a field without a default
        else:
            return False
    return param is None or param in (named_params(obj) or ())


@pytest.mark.parametrize("key", sorted(NOT_PORTED))
def test_not_ported_entry_still_exists_in_jax(key):
    assert NOT_PORTED[key].strip(), f"{key}: no reason given"
    if _wildcard(key) is None:
        assert _resolve_in_jax(key), (
            f"NOT_PORTED names {key}, which the JAX package no longer has")


def test_not_ported_entries_are_still_gaps():
    used = {k for g in all_gaps() for k in excused_by(g)}
    stale = sorted(set(NOT_PORTED) - used)
    assert not stale, (f"the port now has these, or the JAX package no "
                       f"longer does; drop them from NOT_PORTED and from "
                       f"ROADMAP.md: {stale}")


def _roadmap_keys() -> list:
    """The keys of ROADMAP.md's "Deliberately not ported" list: the
    backticked names that open an item of it, up to a colon or the end of
    the line."""
    lines = (ROOT / "ROADMAP.md").read_text().splitlines()
    start = next(i for i, ln in enumerate(lines)
                 if "**Deliberately not ported" in ln)
    indent = len(lines[start]) - len(lines[start].lstrip())
    keys = []
    for ln in lines[start + 1:]:
        stripped = ln.lstrip()
        if stripped.startswith("- ") and len(ln) - len(stripped) <= indent:
            break                        # the next standing note
        m = re.match(r"- ((?:`[^`]+`(?:, )?)+)(?::|$)", stripped)
        if m:
            keys += re.findall(r"`([^`]+)`", m.group(1))
    return keys


def test_roadmap_lists_not_ported_one_for_one():
    keys = _roadmap_keys()
    assert len(keys) == len(set(keys)), "ROADMAP.md lists a key twice"
    assert sorted(keys) == sorted(NOT_PORTED), (
        f"ROADMAP.md's 'Deliberately not ported' list and NOT_PORTED "
        f"differ: only in ROADMAP {sorted(set(keys) - set(NOT_PORTED))}, "
        f"only in the test {sorted(set(NOT_PORTED) - set(keys))}")
