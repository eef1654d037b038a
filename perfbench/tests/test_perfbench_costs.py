"""The yardstick's operation counts against hand counts at a small shape."""
import pytest

from perfbench.harness import costs

CFG = {"hidden_dim": 4, "edge_features": 2, "n_points": 1, "top_k": 3, "num_mpnn_layers": 2,
       "time_embedding_dim": 16}


def test_message_and_chain_operations():
    # B=1, L=5, K=3, H=4, He=2, P=1: edge rows 15, (He + 9P + 2H) H = (2 + 9 + 8) 4 = 76 MACs
    assert costs.message_pass(1, 5, 3, 4, 2, 1, "float32", True)[1] == 2 * 15 * 76
    assert costs.chain_pass(10, 4, "bfloat16", True)[1] == 16 * 10 * 16
    nbytes, _ = costs.chain_pass(10, 4, "float32", False)
    weights = (2 * 4 + 4 * 16 + 16 + 4 * 16 + 4 + 2 * 4) * 4
    assert nbytes == 10 * 4 * 4 * 3 + 10 * 4 + weights


def test_score_net_flops_hand_count():
    H, He, P, K, L = 4, 2, 1, 3, 5
    E = L * K
    hand = E * 468 * He + L * (35 + 16) * H                       # embeddings
    msg = E * ((2 * H + He + 9 * P) * H + 2 * H * H)                # one message MLP
    hand += 2 * (L * H * 3 * P + msg + L * 8 * H * H)              # 2 node passes
    hand += 1 * (L * H * 3 * P + msg + E * 8 * H * H)              # 1 edge pass (last skipped)
    hand += L * (H * 2 + 2 * 1 + 1 * 0 + 0 * 4)                     # decoder 4-2-1, 1-0-4
    assert costs.score_net_flops(L, CFG) == 2 * hand


def test_bound_takes_the_larger_side():
    assert costs.bound_s(3.35e12, 0, "bfloat16") == pytest.approx(1.0)
    assert costs.bound_s(0, 989e12, "bfloat16") == pytest.approx(1.0)
    assert costs.bound_s(0, 165e12, "float32") == pytest.approx(1.0)
