"""The port under the lint gate: raycheck's ``run`` over ``ray_tpu_torch/``
as tests/test_raycheck.py's ``TestLiveTree`` runs it over ``ray_tpu/``,
with every rule and a baseline of the port's own that is empty
(tests/raycheck_torch_baseline.json): zero findings, and no stale entry.
"""

import os

from tools.raycheck import run
from tools.raycheck.rules import RULE_DOCS, builtin_rules

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINE = os.path.join(REPO, "tests", "raycheck_torch_baseline.json")


def test_port_tree_is_clean():
    assert set(builtin_rules()) == set(RULE_DOCS)
    new, old, stale = run([os.path.join(REPO, "ray_tpu_torch")],
                          baseline_path=BASELINE, root=REPO)
    assert new == [], "raycheck findings on ray_tpu_torch/:\n" + \
        "\n".join(f.render() for f in new)
    assert old == [] and stale == []
