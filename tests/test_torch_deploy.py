"""The port's install path (deploy/torch/) and its CI job stay consistent with
the code they describe: the exporter image, the DaemonSet and scrape job for
Hopper node pools, the two locks, and .github/workflows/torch.yml.

These are static checks; ``chip_smoke.py`` phases 3a-3c build the image's
stage and run the DaemonSet's command on an H100.
"""

import pytest

pytest.importorskip("torch")  # the port's own CI job installs it

import ast
import glob
import os
import re
import shlex
import subprocess
import sys
import tomllib
from importlib import metadata
from pathlib import Path

import yaml

from torch_threads import one_torch_thread  # noqa: F401  (autouse)
from tpudash_torch.config import _ENV_MAP, Config, load_config
from tpudash_torch.exporter.server import ExporterServer, make_app

REPO = Path(__file__).resolve().parents[1]
DEPLOY = REPO / "deploy" / "torch"
GPU_LOCK = DEPLOY / "requirements.lock"
CPU_LOCK = DEPLOY / "requirements-cpu.lock"
WORKFLOW = REPO / ".github" / "workflows" / "torch.yml"
INDEX = "https://download.pytorch.org/whl/"


def _canonical(name: str) -> str:
    return re.sub(r"[-_.]+", "-", name).lower()


def _load(path: Path):
    with open(path) as f:
        return yaml.safe_load(f)


def _daemonset() -> dict:
    return _load(DEPLOY / "exporter-daemonset.yaml")


def _container() -> dict:
    (container,) = _daemonset()["spec"]["template"]["spec"]["containers"]
    return container


def _dockerfile() -> str:
    return (DEPLOY / "Dockerfile").read_text()


def _stages() -> list[str]:
    """The Dockerfile cut at each FROM: [preamble, build stage, runtime stage]."""
    return _dockerfile().split("\nFROM ")


def _scripts() -> dict:
    with open(REPO / "pyproject.toml", "rb") as f:
        return tomllib.load(f)["project"]["scripts"]


def _pins(path: Path) -> tuple[dict, set]:
    pins, roots = {}, set()
    for line in path.read_text().splitlines():
        body = line.split("#", 1)[0].strip()
        if not body:
            continue
        name, version = body.split("==")
        pins[name] = version
        if line.endswith("# root"):
            roots.add(name)
    return pins, roots


def _admits(affinity: dict, labels: dict) -> bool:
    """Whether a node with ``labels`` passes a required nodeAffinity: any
    term, all of its expressions (Kubernetes' semantics)."""
    required = affinity["nodeAffinity"]["requiredDuringSchedulingIgnoredDuringExecution"]

    def holds(expr: dict) -> bool:
        key, op, values = expr["key"], expr["operator"], expr.get("values", [])
        if op == "Exists":
            return key in labels
        if op == "DoesNotExist":
            return key not in labels
        if op == "In":
            return key in labels and labels[key] in values
        if op == "NotIn":
            return key not in labels or labels[key] not in values
        if op in ("Gt", "Lt"):
            if key not in labels:
                return False
            a, b = int(labels[key]), int(values[0])
            return a > b if op == "Gt" else a < b
        raise AssertionError(f"unknown operator {op}")

    return any(all(holds(e) for e in term["matchExpressions"])
               for term in required["nodeSelectorTerms"])


# -- the DaemonSet -----------------------------------------------------------


def test_daemonset_selector_is_its_own_and_disjoint_from_the_tpu_one():
    ds = _daemonset()
    assert ds["kind"] == "DaemonSet"
    selector = ds["spec"]["selector"]["matchLabels"]
    labels = ds["spec"]["template"]["metadata"]["labels"]
    assert selector == labels
    tpu = _load(REPO / "deploy" / "exporter-daemonset.yaml")
    tpu_selector = tpu["spec"]["selector"]["matchLabels"]
    tpu_labels = tpu["spec"]["template"]["metadata"]["labels"]
    # neither controller's selector matches the other's pods
    assert not selector.items() <= tpu_labels.items()
    assert not tpu_selector.items() <= labels.items()


def test_daemonset_command_is_the_ports_console_script():
    from tpudash_torch.exporter.server import run

    command = _container()["command"]
    assert len(command) == 1
    target = _scripts()[command[0]]
    assert target == "tpudash_torch.exporter.server:run"
    module, _, attr = target.partition(":")
    assert getattr(__import__(module, fromlist=[attr]), attr) is run


def test_daemonset_env_is_the_configs_and_parses():
    env = {e["name"]: e["value"] for e in _container()["env"]}
    assert env and set(env) <= set(_ENV_MAP.values())
    cfg = load_config(env)
    assert cfg.source == "probe"
    make_app(cfg, device="cpu")  # the exporter serves this source


def test_daemonset_ports_and_readiness_path_agree_with_the_exporter():
    container = _container()
    env = {e["name"]: e["value"] for e in container["env"]}
    (port,) = container["ports"]
    probe = container["readinessProbe"]["httpGet"]
    annotations = _daemonset()["spec"]["template"]["metadata"]["annotations"]
    want = Config().exporter_port
    assert port["containerPort"] == probe["port"] == int(env["TPUDASH_EXPORTER_PORT"]) == want
    assert int(annotations["prometheus.io/port"]) == want
    assert annotations["prometheus.io/scrape"] == "true"
    routes = {(r.method, r.resource.canonical) for r in ExporterServer(None).build_app().router.routes()}
    assert ("GET", probe["path"]) in routes
    assert ("GET", annotations["prometheus.io/path"]) in routes


@pytest.mark.parametrize("major, admitted", [("9", True), ("8", False), ("10", False), (None, False)])
def test_daemonset_requests_gpus_on_compute_major_9_only(major, admitted):
    spec = _daemonset()["spec"]["template"]["spec"]
    assert int(_container()["resources"]["limits"]["nvidia.com/gpu"]) >= 1
    assert any(t["key"] == "nvidia.com/gpu" for t in spec["tolerations"])
    labels = {} if major is None else {"nvidia.com/gpu.compute.major": major}
    assert _admits(spec["affinity"], labels) is admitted


# -- the scrape job ------------------------------------------------------------


def test_scrape_job_keeps_the_gpu_exporter_pods_only():
    (job,) = _load(DEPLOY / "prometheus-scrape.yaml")["scrape_configs"]
    (tpu_job,) = _load(REPO / "deploy" / "prometheus-scrape.yaml")["scrape_configs"]
    app = _daemonset()["spec"]["template"]["metadata"]["labels"]["app"]
    tpu_app = _load(REPO / "deploy" / "exporter-daemonset.yaml")["spec"]["template"]["metadata"][
        "labels"]["app"]

    def keeps(job: dict, source: str, value: str) -> bool:
        rule = next(r for r in job["relabel_configs"]
                    if r.get("action") == "keep" and r["source_labels"] == [source])
        return re.fullmatch(rule["regex"], value) is not None

    app_label = "__meta_kubernetes_pod_label_app"
    assert job["job_name"] == app
    assert keeps(job, app_label, app) and not keeps(job, app_label, tpu_app)
    assert not keeps(tpu_job, app_label, app)
    assert keeps(job, "__meta_kubernetes_pod_annotation_prometheus_io_scrape", "true")
    targets = {r.get("target_label"): r["source_labels"] for r in job["relabel_configs"]}
    assert targets["node"] == ["__meta_kubernetes_pod_node_name"]
    assert ["__meta_kubernetes_node_label_nvidia_com_gpu_product"] in targets.values()
    # a pod target carries its node's labels only with attach_metadata
    assert job["kubernetes_sd_configs"] == [{"role": "pod", "attach_metadata": {"node": True}}]


# -- the image -----------------------------------------------------------------


def test_dockerfile_compiles_the_kernels_in_the_build_stage_only():
    _, build, runtime = _stages()
    assert "devel" in build.splitlines()[0] and "devel" not in runtime.splitlines()[0]
    for word in ("nvcc", "build_kernels"):
        assert word not in runtime
    assert "build_kernels()" in build and "python -P -" in build
    script = build.split("python -P - <<'EOF'\n", 1)[1].split("\nEOF\n", 1)[0]
    ast.parse(script)
    assert "site-packages" in script and "library_path" in script
    # the toolkit's major version is the lock's torch build's
    cuda = re.search(r"\+cu(\d+)", _pins(GPU_LOCK)[0]["torch"]).group(1)
    assert re.search(rf"ARG CUDA_VERSION={cuda[:-1]}\.{cuda[-1]}\.\d+\n", _dockerfile())


def test_dockerfile_installs_the_gpu_lock_without_resolution():
    df = _dockerfile()
    installs = [line for line in re.sub(r"\\\n\s*", " ", df).splitlines() if "pip install" in line]
    assert len(installs) == 2 and all("--no-deps" in line for line in installs)
    assert "-r requirements.lock" in installs[0] and "COPY deploy/torch/requirements.lock ./" in df
    assert installs[1].split("pip install", 1)[1].split("&&")[0].split()[-1] == "."
    index = re.search(r"--extra-index-url (\S+)", installs[0]).group(1)
    assert f"# index for the +{index.rsplit('/', 1)[1]} pins: {index}" in GPU_LOCK.read_text()


def test_dockerfile_runtime_is_unprivileged_with_health_port_and_entrypoint():
    runtime = _stages()[2]
    assert "COPY --from=build /opt/venv /opt/venv" in runtime
    assert "python3 -m venv /opt/venv" in _stages()[1]
    assert "USER 10001" in runtime
    assert "HEALTHCHECK" in runtime and "/healthz" in runtime
    assert f"EXPOSE {Config().exporter_port}" in runtime
    (script,) = [name for name, target in _scripts().items()
                 if target == "tpudash_torch.exporter.server:run"]
    assert f'ENTRYPOINT ["{script}"]' in runtime


def test_dockerfile_copy_sources_exist():
    copies = [line.split()[1:-1] for line in _dockerfile().splitlines()
              if line.startswith("COPY ") and "--from=" not in line]
    assert copies
    for sources in copies:
        for src in sources:
            assert (REPO / src).exists(), src


# -- the locks -----------------------------------------------------------------


def _port_roots() -> set[str]:
    """Distributions of the third-party modules tpudash_torch/**/*.py import."""
    mods = set()
    for path in (REPO / "tpudash_torch").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.Import):
                mods.update(a.name.split(".")[0] for a in node.names)
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods.add(node.module.split(".")[0])
    mods -= set(sys.stdlib_module_names) | {"tpudash_torch", "tpudash"}
    provides = metadata.packages_distributions()
    return {_canonical(d) for m in mods for d in provides[m]}


@pytest.mark.parametrize("lock", [GPU_LOCK, CPU_LOCK], ids=["gpu", "cpu"])
def test_lock_is_exact_sorted_pins(lock):
    lines = [ln for ln in lock.read_text().splitlines() if not ln.startswith("#")]
    names = []
    for line in lines:
        m = re.fullmatch(r"([a-z0-9][a-z0-9-]*)==([A-Za-z0-9.+!]+)(  # root)?", line)
        assert m, f"not an exact pin: {line!r}"
        names.append(m.group(1))
    assert names == sorted(set(names))
    assert f"# python 3.12; {len(names)} packages; roots annotated" in lock.read_text()


@pytest.mark.parametrize("lock", [GPU_LOCK, CPU_LOCK], ids=["gpu", "cpu"])
def test_lock_roots_are_the_ports_third_party_imports(lock):
    assert _pins(lock)[1] == _port_roots()


def test_cpu_lock_regenerates_identically(tmp_path):
    out = tmp_path / "requirements-cpu.lock"
    subprocess.run([sys.executable, str(DEPLOY / "make_lock.py"), "-o", str(out)],
                   check=True, capture_output=True)
    assert out.read_text() == CPU_LOCK.read_text()


def test_gpu_lock_pins_a_cuda_torch_from_its_index_on_a_card():
    text = GPU_LOCK.read_text()
    torch_pin = _pins(GPU_LOCK)[0]["torch"]
    version, cu = re.fullmatch(r"(.+)\+(cu\d+)", torch_pin).groups()
    cuda = f"{cu[2:-1]}.{cu[-1]}"
    assert f"# torch {torch_pin}, cuda {cuda}; card: NVIDIA H100" in text
    assert f"# index for the +{cu} pins: {INDEX}{cu}\n" in text
    # the CUDA build's runtime libraries come in as extras of torch's
    # requirements; the lock walk follows them
    assert {"nvidia-cuda-runtime-cu12", "nvidia-cublas-cu12", "triton"} <= set(_pins(GPU_LOCK)[0])


def test_cpu_lock_agrees_with_the_dashboard_lock():
    """CI installs both locks into one environment."""
    dashboard, _ = _pins(REPO / "requirements.lock")
    cpu, _ = _pins(CPU_LOCK)
    assert "+cpu" in cpu["torch"]
    assert {n: cpu[n] for n in cpu.keys() & dashboard.keys()} == {
        n: dashboard[n] for n in cpu.keys() & dashboard.keys()}


# -- the port's tests in CI ------------------------------------------------------


def _port_test_files() -> list[str]:
    return sorted(os.path.relpath(p, REPO) for p in glob.glob(str(REPO / "tests" / "test_torch_*.py")))


@pytest.mark.parametrize("path", _port_test_files())
def test_port_test_file_skips_before_it_imports_torch(path):
    """Each port test file calls pytest.importorskip("torch") before any
    import of torch or of the torch fixture, so a job without torch skips it
    instead of stopping at collection."""
    tree = ast.parse((REPO / path).read_text())
    skip_at = None
    for i, node in enumerate(tree.body):
        if (isinstance(node, ast.Expr) and isinstance(node.value, ast.Call)
                and ast.unparse(node.value) == "pytest.importorskip('torch')"):
            skip_at = i
            break
    assert skip_at is not None, f"{path}: no pytest.importorskip('torch') at top level"
    for node in tree.body[:skip_at]:
        names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                 [node.module] if isinstance(node, ast.ImportFrom) else [])
        assert not any(n.split(".")[0] in ("torch", "torch_threads", "tpudash_torch")
                       for n in names), f"{path}: imports {names} before the skip"


def test_collection_without_torch_skips_the_port_and_keeps_the_reference(tmp_path):
    """With a torch that fails to import ahead of the real one, collecting a
    reference file beside a port file is not interrupted."""
    (tmp_path / "torch.py").write_text(
        'raise ModuleNotFoundError("No module named torch (hidden)", name="torch")\n')
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (str(tmp_path), os.environ.get("PYTHONPATH", "")) if p)}
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "--collect-only", "-q", "-rs", "-p", "no:cacheprovider",
         "tests/test_config.py", "tests/test_torch_source.py"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    out = r.stdout + r.stderr
    assert r.returncode == 0, out
    assert "Interrupted" not in out and "ERROR" not in out, out
    assert any(line.startswith("tests/test_config.py::") for line in r.stdout.splitlines()), out
    assert not any(line.startswith("tests/test_torch_source.py::") for line in r.stdout.splitlines())
    assert "SKIPPED [1] tests/test_torch_source.py" in out, out


def test_torch_workflow_installs_both_locks_and_runs_every_port_test_unskipped():
    wf = _load(WORKFLOW)
    runs = [s["run"] for job in wf["jobs"].values() for s in job["steps"] if "run" in s]
    text = re.sub(r"\\\n\s*", " ", "\n".join(runs))
    installs = [line.strip() for line in text.splitlines() if "pip install" in line and " -r " in line]
    assert [line.split(" -r ")[1].split()[0] for line in installs] == [
        "requirements.lock", "deploy/torch/requirements-cpu.lock"]
    assert all("--no-deps" in line for line in installs)
    assert f"--extra-index-url {INDEX}cpu" in installs[1]
    assert f"# index for the +cpu pins: {INDEX}cpu" in CPU_LOCK.read_text()
    # both packages must import before the tests run, so that no skip fires
    imports = text.index('python -c "import torch, jax')
    (pytest_line,) = [line for line in text.splitlines() if "-m pytest" in line]
    assert imports < text.index(pytest_line)
    args = shlex.split(pytest_line.split("-m pytest", 1)[1].split("|")[0])
    named = sorted({os.path.relpath(p, REPO) for a in args if a.startswith("tests/")
                    for p in glob.glob(str(REPO / a))})
    assert named == _port_test_files()
    assert "-rs" in args and re.search(r"grep -E '\^SKIPPED'.*\n.*\n\s*exit 1", text)
