"""The port's lint gate: ``crdt_tpu/`` and ``crdt_tpu_torch/`` linted
together by crdtlint leave no open finding and no stale baseline
entry. The names only the port emits are registered by the first cell
of each row of the README table "The port's own spans and counters";
they stand there out of backticks, so the reference's own registry
(and ``python -m tools.crdtlint crdt_tpu/``) never reads them."""

import os
import re

from tools.crdtlint.core import LintConfig, load_modules, run_lint
from tools.crdtlint.registry import load_registry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_TABLE = "### The port's own spans and counters"


def port_names(readme: str):
    """{name: README line} of the port's table, label suffixes
    (``{path=...}``) stripped."""
    names, inside, rows = {}, False, False
    with open(readme, encoding="utf-8") as f:
        for lineno, line in enumerate(f, start=1):
            if line.startswith("#"):
                inside, rows = line.strip() == PORT_TABLE, False
            elif inside and line.startswith("|---"):
                rows = True  # the rows follow the header's rule
            elif rows and line.startswith("| "):
                cell = line.split("|")[1].strip()
                name = re.sub(r"\{[^}]*\}$", "", cell)
                if re.fullmatch(r"[a-z][a-z0-9_]*(\.[a-z0-9_]+)*", name):
                    names.setdefault(name, lineno)
    return names


def test_both_packages_lint_clean():
    config = LintConfig(repo_root=REPO)
    reg = load_registry(config.readme_path, config.smoke_test_path)
    for name, lineno in port_names(config.readme_path).items():
        reg.add(name, "metric", config.readme_path, lineno)
    modules = load_modules(
        [os.path.join(REPO, "crdt_tpu"), os.path.join(REPO, "crdt_tpu_torch")],
        REPO,
    )
    # no wall-clock bound: the run shares the machine with the rest of
    # the tests
    result = run_lint(modules, config=config,
                      shared={"metric_registry": reg})
    assert not result.findings, "crdtlint found unsuppressed violations:\n" \
        + "\n".join(f.format() for f in result.findings)
    assert not result.stale_baseline, result.stale_baseline


def test_port_table_is_not_the_reference_registry():
    config = LintConfig(repo_root=REPO)
    names = port_names(config.readme_path)
    assert {"decode.parse", "pack.rights.scan", "columns", "fleet.load",
            "materialize.rows", "rights.scanned_rows",
            "tenant.pool_refusals"} <= set(names)
    # a port-only name the reference's README parse read would be a
    # dead entry whenever crdt_tpu/ is linted alone
    ref = load_registry(config.readme_path, config.smoke_test_path)
    assert not set(names) & ref.all_names
