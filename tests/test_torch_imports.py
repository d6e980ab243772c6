"""The port and its smoke script load neither JAX nor the JAX package
(nor ``ml_dtypes``, which the card's machine does not have)."""
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
IMPORT_RE = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)", re.M)


def _modules():
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(PORT.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_import_loads_no_jax():
    mods = list(_modules())
    assert "repro_torch.core.engine" in mods
    # the static verifier, its CLI and the byte model load no JAX either
    assert {"repro_torch.analysis.conservation", "repro_torch.analysis.lint",
            "repro_torch.analysis.__main__",
            "repro_torch.roofline.analysis"} <= set(mods)
    # and neither do the GNN zoo, the sampler and the GNN cells
    assert {"repro_torch.models.gnn.dimenet", "repro_torch.models.gnn.nequip",
            "repro_torch.models.gnn.so3", "repro_torch.models.gnn.equiformer_v2",
            "repro_torch.graphs.sampler", "repro_torch.launch.steps",
            "repro_torch.configs.dimenet", "repro_torch.configs.nequip",
            "repro_torch.configs.equiformer_v2"} <= set(mods)
    # nor does the LM serving path
    assert {"repro_torch.models.transformer", "repro_torch.models.moe",
            "repro_torch.data.tokens", "repro_torch.launch.serve",
            "repro_torch.configs.internlm2_1_8b",
            "repro_torch.configs.phi3_mini_3_8b",
            "repro_torch.configs.command_r_plus_104b",
            "repro_torch.configs.llama4_maverick_400b_a17b",
            "repro_torch.configs.kimi_k2_1t_a32b"} <= set(mods)
    # nor does LM training
    assert {"repro_torch.checkpoint", "repro_torch.checkpoint.manager",
            "repro_torch.launch.train", "repro_torch.launch.elastic",
            "repro_torch.examples.train_lm"} <= set(mods)
    code = ("import sys, importlib\n"
            f"sys.path.insert(0, {str(ROOT)!r})\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "import chip_smoke\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'ml_dtypes')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_sources_import_no_jax():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    hits = [f"{f}: {m.group(0).strip()}" for f in files
            for m in IMPORT_RE.finditer(f.read_text())]
    assert not hits, hits
