"""The port stands alone: graphecho_torch and chip_smoke.py import neither JAX
(nor flax, optax, orbax) nor anything of graphecho_tpu, and nothing of the
port falls back to the CPU on its own. The GPU machine has no cv2, pandas,
tensorboardX or nibabel: no port module imports one of them at module level
(EchoNet's reader imports cv2 and pandas when it runs, the summary writer
tensorboardX when it is there)."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's default of a thread per core oversubscribes the machine
    (tens of times slower under load)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ROOT = Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "graphecho_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "graphecho_tpu")
NOT_ON_THE_CARD = ("cv2", "pandas", "tensorboardX", "nibabel")


def _modules():
    return sorted(".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
                  for p in PACKAGE.rglob("*.py"))


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for name in {_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_every_module_imports_without_the_packages_the_card_lacks():
    """Each module imports with cv2, pandas, tensorboardX and nibabel made
    unimportable, as on the GPU machine."""
    code = (
        "import importlib, sys\n"
        f"for name in {NOT_ON_THE_CARD!r}:\n"
        "    sys.modules[name] = None\n"
        f"for name in {_modules()!r}:\n"
        "    importlib.import_module(name)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _module_level(tree):
    """The statements that run at import: everything outside a function body."""
    todo = list(tree.body)
    while todo:
        node = todo.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        yield node
        todo.extend(ast.iter_child_nodes(node))


@pytest.mark.parametrize("path", sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_level_import_of_what_the_card_lacks(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in _module_level(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names = [node.module]
        for name in names:
            assert name.split(".")[0] not in NOT_ON_THE_CARD, f"{path.name}:{node.lineno} {name}"


@pytest.mark.parametrize("path", sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names = [node.module]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names = [node.args[0].value]
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path.name}:{node.lineno} {name}"


def test_entry_point_without_device_raises_when_there_is_no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    from graphecho_torch import entrypoints

    with pytest.raises(RuntimeError, match="device='cpu'"):
        entrypoints.train_camus_echo(num_epochs=1, steps_per_epoch=1)


def test_chip_smoke_fails_without_a_gpu_and_alone(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run for real")
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"), (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_text((ROOT / "chip_smoke.py").read_text())
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True,
                              text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout


@pytest.mark.parametrize("modname", _modules())
def test_annotations_resolve(modname):
    """Every annotation of the port resolves (`from __future__ import
    annotations` would otherwise hide a missing import), as
    `tests/test_lint.py` checks for the JAX package."""
    import importlib
    import inspect
    import typing

    mod = importlib.import_module(modname)
    objs = [(n, o) for n, o in inspect.getmembers(mod, inspect.isfunction)
            if o.__module__ == modname]
    for cname, cls in inspect.getmembers(mod, inspect.isclass):
        if cls.__module__ == modname:
            objs.append((cname, cls))
            objs += [(f"{cname}.{n}", m) for n, m in inspect.getmembers(cls, inspect.isfunction)
                     if m.__module__ == modname]
    for name, obj in objs:
        try:
            typing.get_type_hints(obj)
        except NameError as e:
            raise AssertionError(f"{modname}.{name}: unresolvable annotation: {e}")


NEW_IN_THE_LAST_SLICE = ("graphecho_torch.parallel.mesh", "graphecho_torch.utils.tools",
                         "graphecho_torch.utils.profiling", "graphecho_torch.utils.torch_import",
                         "graphecho_torch.utils.metric_wrappers",
                         "graphecho_torch.utils.visualize")


def test_the_parallel_and_tooling_modules_are_held_here():
    """The data-parallel mesh and the five tooling modules are among the
    modules every test above imports and reads, so the same rules hold them."""
    assert set(NEW_IN_THE_LAST_SLICE) <= set(_modules())


def test_nothing_of_the_jax_package_is_left_unported():
    """No module of the port refuses an option as not yet ported."""
    for path in sorted(PACKAGE.rglob("*.py")):
        text = path.read_text()
        assert "not ported" not in text and "NotImplementedError" not in text, path.name


NEW_IN_THIS_SLICE = ("graphecho_torch.data.native", "graphecho_torch.train_rehearsal",
                     "graphecho_torch.rehearsal_report")


def test_the_data_kernels_and_the_rehearsal_are_held_here():
    """The native data binding and the rehearsal modules are among the
    modules every test above imports and reads, so the same rules hold them."""
    assert set(NEW_IN_THIS_SLICE) <= set(_modules())


def test_the_native_binding_builds_and_loads_its_own_library():
    """`data/native.py` loads the library it builds from `csrc/dataops.cpp`
    into `graphecho_torch/_build/`, never the JAX package's
    `native/libdataops.so`, and imports nothing of the JAX package."""
    code = (
        "import sys\n"
        "from graphecho_torch.data import native, transforms\n"
        "import numpy as np\n"
        "transforms.nearest_resize(np.zeros((4, 4, 1), np.float32), (8, 8))\n"
        "maps = open('/proc/self/maps').read()\n"
        "libs = sorted({line.split()[-1] for line in maps.splitlines() if 'dataops' in line})\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(libs, bad)\n"
        "sys.exit(0 if len(libs) == 1 and '/graphecho_torch/_build/libdataops-' in libs[0]\n"
        "         and not bad else 1)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
