"""The port's dry-run table (``python -m repro_torch.launch.dryrun --all
--both-meshes``), one case per (arch id, shape): the single-pod record with
its cost pair and roofline on the H100's figures, and the multi-pod
record's resident bytes. Every record is counted on the CPU under fake
tensors, no card: about 3 minutes on one core for these cases. xLSTM's
cost pairs at prefill_32k and train_4k (its sLSTM loop, ~0.3 ms an op
under fake tensors, counted at 512 and 768 steps and extrapolated along
the length: 90 s and 354 s alone) are left to the command line here:
those two cases check the resident bytes of both records, and
``tests/test_torch_dryrun.py`` holds the extrapolation to a direct count.
"""
import pytest

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.models.config import SHAPES

TERMS = ("compute_s", "memory_s", "collective_s")
# counted by the command line only (see above)
SLOW = {("xlstm_1_3b", "train_4k"), ("xlstm_1_3b", "prefill_32k")}


@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_the_dryrun_record(arch, shape_name):
    roofline = (arch, shape_name) not in SLOW
    single = dryrun.lower_pair(arch, shape_name, roofline=roofline, verbose=False)
    multi = dryrun.lower_pair(arch, shape_name, multi_pod=True, verbose=False)
    if dryrun.skip_reason(get_config(arch), SHAPES[shape_name]):
        assert "skipped" in single and "skipped" in multi
        return
    assert (single["mesh"], multi["mesh"]) == ("16x16", "2x16x16")
    assert "roofline" not in multi
    for rec in (single, multi):
        mem = rec["memory"]
        assert mem["param_bytes"] > 0 and "not counted" in mem["activations"]
        assert rec["fits_hbm"] == (mem["resident_bytes"] <= tmesh.HBM_PER_CARD)
    if not roofline:
        assert "roofline" not in single
        assert (single["memory"]["state_bytes"] > 0) == (shape_name == "train_4k")
        return
    roof = single["roofline"]
    cfg = get_config(arch)
    assert roof["chips"] == 256
    assert roof["model_flops"] == dryrun.model_flops(cfg, SHAPES[shape_name])
    assert roof["hlo_flops"] > 0 and roof["hlo_bytes"] > 0
    assert roof["dominant"] == max(TERMS, key=roof.get).removesuffix("_s")
    peak = tmesh.PEAK_FLOPS_F32 if cfg.param_dtype == "float32" else tmesh.PEAK_FLOPS_BF16
    assert roof["compute_s"] == pytest.approx(roof["hlo_flops"] / (256 * peak))
    for c in (single["cost_2p"], single["cost_4p"]):
        assert c["flops"] > 0
    assert single["cost_4p"]["flops"] > single["cost_2p"]["flops"]
    # every mesh device is a rank of a model axis of 16: it all-reduces
    assert roof["collective_bytes"] > 0 and roof["collective_s"] > 0
