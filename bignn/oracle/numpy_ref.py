"""Edge-loop NumPy implementations of every layer (SURVEY.md T8).

Deliberately naive: python loops over edges, dense per-node accumulators.
Parameters are the *same pytrees* produced by the JAX modules' ``init`` so
tests can feed identical weights to both paths.
"""

from __future__ import annotations

import numpy as np


def _np(p):
    return np.asarray(p, np.float64)


def _act(name: str):
    return {
        "relu": lambda x: np.maximum(x, 0.0),
        "elu": lambda x: np.where(x > 0, x, np.expm1(x)),
        "tanh": np.tanh,
        "sigmoid": lambda x: 1.0 / (1.0 + np.exp(-x)),
        "identity": lambda x: x,
        "none": lambda x: x,
        "leaky_relu": lambda x: np.where(x > 0, x, 0.01 * x),
        "gelu": lambda x: 0.5 * x * (1.0 + np.tanh(np.sqrt(2 / np.pi) * (x + 0.044715 * x**3))),
    }[name]


def _leaky_relu(x, slope):
    return np.where(x > 0, x, slope * x)


def spmm_ref(x, src, dst, w, num_out):
    """out[d] += w_e * x[s] — plain edge loop."""
    out = np.zeros((num_out, x.shape[1]), np.float64)
    for e in range(len(src)):
        d = int(dst[e])
        if d < num_out:
            we = 1.0 if w is None else float(w[e])
            out[d] += we * x[int(src[e])]
    return out


def segment_softmax_ref(scores, seg, num_segments):
    scores = _np(scores)
    out = np.zeros_like(scores)
    for s in range(num_segments):
        m = np.asarray(seg) == s
        if not m.any():
            continue
        sub = scores[m]
        e = np.exp(sub - sub.max(axis=0, keepdims=True))
        out[m] = e / e.sum(axis=0, keepdims=True)
    return out


def mlp_ref(params, dims, activation, x, activate_final=False):
    n_layers = len(dims) - 1
    for i in range(n_layers):
        p = params[f"layer_{i}"]
        x = x @ _np(p["w"]) + _np(p["b"])
        if i < n_layers - 1 or activate_final:
            x = _act(activation)(x)
    return x


def gcn_conv_ref(params, x, src, dst, w, num_nodes, activation="relu"):
    h = _np(x) @ _np(params["w"])
    agg = spmm_ref(h, src, dst, w, num_nodes)
    return _act(activation)(agg + _np(params["b"]))


def gin_conv_ref(params, x, src, dst, num_nodes, in_dim, out_dim, hidden=None,
                 activation="relu"):
    x = _np(x)
    agg = spmm_ref(x, src, dst, None, num_nodes)
    h = agg + float(params["eps"]) * x
    hidden = hidden or out_dim
    out = mlp_ref(params["mlp"], (in_dim, hidden, out_dim), activation, h)
    return _act(activation)(out)


def gat_conv_ref(params, x, src, dst, num_nodes, heads, activation="relu",
                 negative_slope=0.2):
    x = _np(x)
    w = _np(params["w"])
    out_dim = w.shape[1]
    D = out_dim // heads
    h = (x @ w).reshape(-1, heads, D)
    a_l, a_r = _np(params["a_l"]), _np(params["a_r"])
    sl = (h * a_l).sum(-1)  # [N, H]
    sr = (h * a_r).sum(-1)
    E = len(src)
    scores = np.zeros((E, heads))
    valid = np.zeros(E, bool)
    for e in range(E):
        d = int(dst[e])
        if d < num_nodes:
            scores[e] = _leaky_relu(sl[d] + sr[int(src[e])], negative_slope)
            valid[e] = True
    out = np.zeros((num_nodes, heads, D))
    for n in range(num_nodes):
        m = (np.asarray(dst) == n) & valid
        if not m.any():
            continue
        sub = scores[m]
        e_exp = np.exp(sub - sub.max(axis=0, keepdims=True))
        alpha = e_exp / e_exp.sum(axis=0, keepdims=True)  # [k, H]
        srcs = np.asarray(src)[m]
        out[n] = np.einsum("kh,khd->hd", alpha, h[srcs])
    out = out.reshape(num_nodes, out_dim) + _np(params["b"])
    return _act(activation)(out)


def dotattn_conv_ref(params, x, src, dst, num_nodes, heads, activation="relu"):
    x = _np(x)
    out_dim = _np(params["wq"]).shape[1]
    D = out_dim // heads
    q = (x @ _np(params["wq"])).reshape(-1, heads, D)
    k = (x @ _np(params["wk"])).reshape(-1, heads, D)
    v = (x @ _np(params["wv"])).reshape(-1, heads, D)
    E = len(src)
    scores = np.zeros((E, heads))
    valid = np.zeros(E, bool)
    for e in range(E):
        d = int(dst[e])
        if d < num_nodes:
            scores[e] = (q[d] * k[int(src[e])]).sum(-1) / np.sqrt(D)
            valid[e] = True
    out = np.zeros((num_nodes, heads, D))
    for n in range(num_nodes):
        m = (np.asarray(dst) == n) & valid
        if not m.any():
            continue
        sub = scores[m]
        e_exp = np.exp(sub - sub.max(axis=0, keepdims=True))
        alpha = e_exp / e_exp.sum(axis=0, keepdims=True)
        out[n] = np.einsum("kh,khd->hd", alpha, v[np.asarray(src)[m]])
    out = out.reshape(num_nodes, out_dim) + _np(params["b"])
    return _act(activation)(out)


def readout_ref(kind, x, graph_ids, num_graphs):
    x = _np(x)
    out_dim = x.shape[1]
    out = np.zeros((num_graphs, out_dim))
    for g in range(num_graphs):
        m = np.asarray(graph_ids) == g
        if not m.any():
            continue
        if kind == "sum":
            out[g] = x[m].sum(0)
        elif kind == "mean":
            out[g] = x[m].mean(0)
        elif kind == "max":
            out[g] = x[m].max(0)
        else:
            raise ValueError(kind)
    return out


def attention_readout_ref(params, x, graph_ids, num_graphs, dim, hidden=64):
    x = _np(x)
    gate = mlp_ref(params["gate"], (dim, hidden, 1), "tanh", x)[:, 0]
    proj = x @ _np(params["proj"])
    out = np.zeros((num_graphs, dim))
    for g in range(num_graphs):
        m = np.asarray(graph_ids) == g
        if not m.any():
            continue
        sub = gate[m]
        a = np.exp(sub - sub.max())
        a = a / a.sum()
        out[g] = (proj[m] * a[:, None]).sum(0)
    return out


def dot_score_ref(emb, pairs):
    emb = _np(emb)
    return np.array([emb[int(u)] @ emb[int(v)] for u, v in pairs])


def mlp_score_ref(params, emb, pairs, dim, hidden=64):
    emb = _np(emb)
    hu = emb[np.asarray(pairs)[:, 0]]
    hv = emb[np.asarray(pairs)[:, 1]]
    feat = np.concatenate([hu * hv, np.abs(hu - hv), hu + hv], axis=-1)
    return mlp_ref(params["mlp"], (3 * dim, hidden, 1), "relu", feat)[:, 0]


def bignn_forward_ref(model, params, buckets, graph_index, outer, pairs):
    """Full bi-level forward with the oracle layers, for config-#1 models
    (GCN/GIN inner, GCN/GAT outer, sum/mean/max readout, dot/mlp scorer)."""
    from bignn.models.convs import DotAttnConv, GATConv, GCNConv, GINConv
    from bignn.models.readout import AttentionReadout
    from bignn.models.scorer import DotScorer

    inner_layers, inner_dim = model._inner_stack()
    num_drugs = outer.num_nodes
    emb = np.zeros((num_drugs, inner_dim))

    def run_conv(conv, p, x, src, dst, w, n):
        if isinstance(conv, GCNConv):
            return gcn_conv_ref(p, x, src, dst, w, n, conv.activation)
        if isinstance(conv, GINConv):
            return gin_conv_ref(p, x, src, dst, n, conv.in_dim, conv.out_dim,
                                conv.hidden_dim, conv.activation)
        if isinstance(conv, GATConv):
            return gat_conv_ref(p, x, src, dst, n, conv.heads, conv.activation,
                                conv.negative_slope)
        if isinstance(conv, DotAttnConv):
            return dotattn_conv_ref(p, x, src, dst, n, conv.heads, conv.activation)
        raise TypeError(conv)

    for batch, gidx in zip(buckets, graph_index):
        x = _np(batch.node_feat)
        for i, conv in enumerate(inner_layers):
            x = run_conv(conv, params["inner"][f"layer_{i}"], x,
                         batch.edge_src, batch.edge_dst, batch.edge_weight,
                         batch.node_cap)
        if isinstance(model._readout_obj(), AttentionReadout):
            r = model._readout_obj()
            g = attention_readout_ref(params["readout"], x, batch.graph_ids,
                                      batch.num_graphs, r.dim, r.hidden)
        else:
            g = readout_ref(model.config.readout.split(":")[0], x,
                            batch.graph_ids, batch.num_graphs)
        emb[np.asarray(gidx)] = g

    outer_layers, _ = model._outer_stack(inner_dim)
    for i, conv in enumerate(outer_layers):
        emb = run_conv(conv, params["outer"][f"layer_{i}"], emb,
                       outer.edge_src, outer.edge_dst, outer.edge_weight,
                       outer.num_nodes)

    scorer = model._scorer_obj()
    if isinstance(scorer, DotScorer):
        return dot_score_ref(emb, pairs)
    return mlp_score_ref(params["scorer"], emb, pairs, scorer.dim, scorer.hidden)
