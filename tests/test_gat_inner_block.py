"""GAT/DotAttn-inner fast path: per-block dense
masked attention must match the sparse segment-softmax path, and GAT-inner
models must ride the quantized resident pipeline end-to-end."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bignn.data import make_synthetic_ddi, prepare_device_data
from bignn.models import BiGNN, BiGNNConfig
from bignn.models.convs import parse_conv
from bignn.sparse.bucketing import bucket_graphs
from bignn.train.trainer import MinibatchTrainer, Trainer, TrainConfig


@pytest.fixture(scope="module")
def block_batch():
    ds = make_synthetic_ddi(num_drugs=24, feat_dim=8, avg_degree=5.0,
                            min_atoms=4, max_atoms=12, seed=0)
    bucketing = bucket_graphs(ds.molecules, max_buckets=1)
    b = bucketing.batches[0]
    assert b.block_adj is not None  # block-local + dense blocks built
    return jax.tree.map(jnp.asarray, b)


@pytest.mark.parametrize("spec", ["gat:16:2", "dotattn:16:2"])
def test_block_dense_attention_matches_sparse(block_batch, spec):
    b = block_batch
    conv = parse_conv(spec, b.node_feat.shape[1])
    params = conv.init(jax.random.key(0))
    sparse = conv.apply(params, b.node_feat, b.edge_src, b.edge_dst,
                        b.edge_weight, b.node_cap)
    dense = conv.apply(params, b.node_feat, b.edge_src, b.edge_dst,
                       b.edge_weight, b.node_cap,
                       block_dense=(b.block_adj, b.block_cnt))
    # compare on real rows only (padding rows differ: sparse leaves them 0
    # via segment ids; both should be 0 though — mask to be safe)
    m = np.asarray(b.node_mask)[:, None]
    np.testing.assert_allclose(
        np.asarray(dense) * m, np.asarray(sparse) * m, rtol=2e-4, atol=2e-5)


def test_gat_inner_resident_quantized_end_to_end():
    ds = make_synthetic_ddi(num_drugs=48, feat_dim=8, avg_degree=6.0,
                            min_atoms=4, max_atoms=10, seed=0)
    model = BiGNN(BiGNNConfig(
        feat_dim=8, inner_layers=("gat:16:2", "gin:16"),
        outer_layers=("gat:16:2:identity",), scorer="mlp:16"))
    cfg = TrainConfig(batch_size=8, epochs=1)
    mb = MinibatchTrainer(model, ds, cfg, fanouts=(4,), calibrate_caps=2)
    # GAT inner no longer forces the exact (non-quantized) layout
    assert mb.sampler.quantized and mb.dense_inner

    params, opt_state = mb.init()
    params, opt_state, loss = mb.train_step(params, opt_state)
    assert np.isfinite(float(loss))

    # full-propagation scores through the resident quantized expansion match
    # the full-graph trainer (same math, different layout machinery)
    full = Trainer(model, prepare_device_data(ds), cfg)
    rng = np.random.default_rng(3)
    pairs = rng.integers(0, ds.num_drugs, (32, 2)).astype(np.int64)
    s_mb = mb.score_exact(params, pairs)
    s_full = np.asarray(full._score_pairs(params, jnp.asarray(pairs, jnp.int32)))
    np.testing.assert_allclose(s_mb, s_full, rtol=2e-4, atol=2e-5)
