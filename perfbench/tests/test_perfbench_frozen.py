"""The numbers the two cells read stay as they were when the weight trees
and the kernels' call counts moved into the families' own files
(``reference/<family>.py``, ``counts/model_<family>.py``): each
configuration's tree (paths and shapes), a checksum of every leaf drawn at
its CPU cut for a fixed seed, and K5's and K6's launches and the model
FLOPs at each prompt length of its cell, all recorded before the move."""
from __future__ import annotations

import hashlib
import json

import pytest
import torch

from perfbench import weights
from perfbench.bench import Context, load_cell
from perfbench.counts import k5, k6
from perfbench.tests.tiny import HERE, TINY

SHAPES = {
    "zamba2-1.2b": {
        "blocks/ln1": (38, 2048),
        "blocks/ssm/a_log": (38, 64),
        "blocks/ssm/d_skip": (38, 64),
        "blocks/ssm/dt_bias": (38, 64),
        "blocks/ssm/norm": (38, 4096),
        "blocks/ssm/w_in": (38, 2048, 8384),
        "blocks/ssm/w_out": (38, 4096, 2048),
        "embed": (32000, 2048),
        "final_norm": (2048,),
        "lm_head": (32000, 2048),
        "shared_attn/attn/wk": (2048, 4096),
        "shared_attn/attn/wo": (4096, 2048),
        "shared_attn/attn/wq": (2048, 4096),
        "shared_attn/attn/wv": (2048, 4096),
        "shared_attn/ln1": (2048,),
        "shared_attn/ln2": (2048,),
        "shared_attn/mlp/wd": (8192, 2048),
        "shared_attn/mlp/wg": (2048, 8192),
        "shared_attn/mlp/wu": (2048, 8192),
    },
    "mixtral-8x22b": {
        "blocks/attn/wk": (7, 6144, 1024),
        "blocks/attn/wo": (7, 6144, 6144),
        "blocks/attn/wq": (7, 6144, 6144),
        "blocks/attn/wv": (7, 6144, 1024),
        "blocks/ln1": (7, 6144),
        "blocks/ln2": (7, 6144),
        "blocks/moe/router": (7, 6144, 8),
        "blocks/moe/wd": (7, 8, 16384, 6144),
        "blocks/moe/wg": (7, 8, 6144, 16384),
        "blocks/moe/wu": (7, 8, 6144, 16384),
        "embed": (32768, 6144),
        "final_norm": (6144,),
        "lm_head": (32768, 6144),
    },
}

SEED = 2**31 + 3
# the first 16 hex digits of the sha256 of each leaf's bytes (bfloat16), at the CPU cut
CHECKSUMS = {
    "zamba2-1.2b": {
        "blocks/ln1": "fed6850afa32ab70",
        "blocks/ssm/a_log": "dfb8e17513879c77",
        "blocks/ssm/d_skip": "a8a7d71b078f2358",
        "blocks/ssm/dt_bias": "0ea8035f39ed8778",
        "blocks/ssm/norm": "3699a85a216e07cf",
        "blocks/ssm/w_in": "54ac815c17e1ad17",
        "blocks/ssm/w_out": "99f90132e412cf2b",
        "embed": "041f4e50e9bec8d2",
        "final_norm": "4fc86cd7db7d1c89",
        "lm_head": "06b935cd029a5366",
        "shared_attn/attn/wk": "73ec664959bc1740",
        "shared_attn/attn/wo": "8f6cecfaf0033913",
        "shared_attn/attn/wq": "c011bab487888751",
        "shared_attn/attn/wv": "baf56378e2255d38",
        "shared_attn/ln1": "9338ef93bdecbade",
        "shared_attn/ln2": "08b14e4312a431cb",
        "shared_attn/mlp/wd": "9e3c6bfa35cfaa52",
        "shared_attn/mlp/wg": "6d6740a92195542b",
        "shared_attn/mlp/wu": "d1ca2625e512e1c9",
    },
    "mixtral-8x22b": {
        "blocks/attn/wk": "e7eb5272b1963510",
        "blocks/attn/wo": "b6239eab9cc1b6bd",
        "blocks/attn/wq": "a592ee234249d867",
        "blocks/attn/wv": "a327f3947c525089",
        "blocks/ln1": "c60b31aa500c9858",
        "blocks/ln2": "b57d1ac8531ecafd",
        "blocks/moe/router": "2216dadc98cfe693",
        "blocks/moe/wd": "7df519e5b4c05b29",
        "blocks/moe/wg": "809b756b3331adf4",
        "blocks/moe/wu": "1341208439874692",
        "embed": "041f4e50e9bec8d2",
        "final_norm": "4fc86cd7db7d1c89",
        "lm_head": "06b935cd029a5366",
    },
}

# a batch of each prompt length of the cell's traffic: length: (rows, (K5's
# launches, (operations, bytes) each), (K6's launches, the same), model FLOPs)
COUNTS = {
    "zamba2-1.2b.prefill": {
        1024: (32, (6, (275146342400, 1073741824)), (38, (69392662528, 587202816)),
               100928757694464),
        2048: (16, (6, (550024249344, 1073741824)), (38, (69392662528, 570425600)),
               102575927984128),
        4096: (8, (6, (1099780063232, 1073741824)), (38, (69392662528, 562036992)),
               105873414291456),
    },
    "mixtral-8x22b.prefill": {
        2048: (16, (7, (825036374016, 939524096)), (0, None),
               323288228167680),
        4096: (8, (7, (1649670094848, 939524096)), (0, None),
               329057442988032),
        8192: (4, (7, (3298937536512, 939524096)), (0, None),
               340600704466944),
        16384: (2, (7, (6597472419840, 939524096)), (0, None),
               363689643343872),
    },
}


def config(name: str) -> dict:
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_tree_paths_and_shapes(name):
    got = {"/".join(p): s for p, s in weights.tree_shapes(config(name)).items()}
    assert got == SHAPES[name]


@pytest.mark.parametrize("name", sorted(CHECKSUMS))
def test_leaf_checksums(name):
    cfg = dict(config(name), **TINY[name])
    tree = weights.draw_tree(cfg, SEED, "cpu")
    got = {}
    for path in weights.tree_shapes(cfg):
        leaf = tree
        for key in path:
            leaf = leaf[key]
        data = leaf.contiguous().view(torch.int16).numpy().tobytes()
        got["/".join(path)] = hashlib.sha256(data).hexdigest()[:16]
    assert got == CHECKSUMS[name]


@pytest.mark.parametrize("cell_name", sorted(COUNTS))
def test_kernel_and_model_counts(cell_name):
    cell = load_cell(cell_name)
    ctx = Context(cell, {}, [], 1.0)
    assert sorted(COUNTS[cell_name]) == sorted(cell.traffic.lengths)
    for length, (rows, (n5, l5), (n6, l6), flops) in COUNTS[cell_name].items():
        assert cell.traffic.rows(length) == rows
        assert k5.launches(cell.config, rows, length) == [l5] * n5
        assert k6.launches(cell.config, rows, length) == ([l6] * n6 if n6 else [])
        assert ctx.model_flops(rows, length) == flops
