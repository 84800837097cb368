"""The yardstick's counts against hand counts at tiny shapes."""
import pytest

from portbench import counts


def test_knn_bound_is_the_larger_of_operations_and_bytes():
    # 2 x 4 queries against 2 x 5 rows of 3 coordinates, k = 2
    ops = 2 * 4 * 5 * (8 + 1)
    nbytes = 4 * (2 * 4 * 3 + 2 * 5 * 3) + 8 * 2 * 4 * 2
    assert counts.knn_s(2, 4, 5, 3, 2) == pytest.approx(
        max(ops / counts.PEAK_F32_OPS, nbytes / counts.PEAK_BYTES))


def test_nn1_bound():
    # 6 query sets of 4 points, 3 per cloud, 2 clouds of 5 rows
    ops = 6 * 4 * 5 * 9
    nbytes = 4 * (6 * 4 * 3 + 2 * 5 * 3) + 8 * 6 * 4
    assert counts.nn1_s(6, 4, 2, 5) == pytest.approx(
        max(ops / counts.PEAK_F32_OPS, nbytes / counts.PEAK_BYTES))


def test_main_path_bounds_match_the_kernel_table():
    cfg = dict(input_pt_num=20480, node_a_num=128, node_b_num=128,
               k_interp_point_a=3, k_ab=16, k_interp_point_b=3,
               k_interp_ab=3)
    knn = sum(counts.knn_s(*c) for c in counts.detector_knn_calls(cfg, 32))
    assert knn * 1e3 == pytest.approx(0.0228, abs=5e-5)
    assert counts.nn1_s(512, 20480, 8, 5120) * 1e3 == pytest.approx(
        7.212, abs=1e-3)


def test_lm_ops_by_label():
    # 3 inside and 2 outside points, 4 inits, 5 full sweeps + the last
    assert counts.lm_ops(3, 2, 4, 5) == 4 * (3 * (5 * 134 + 35)
                                             + 2 * (5 * 102 + 30))


def test_resnet34_at_224_is_the_published_3_6_gmac():
    assert counts.resnet34_flops(224, 224) / 2 == pytest.approx(3.66e9,
                                                                rel=0.01)


def test_detector_flops_by_hand_at_a_tiny_shape():
    cfg = dict(input_pt_num=10, node_a_num=2, node_b_num=3, k_ab=2,
               k_interp_point_a=3, k_interp_point_b=3, k_interp_ab=3,
               node_feature_a=4, node_feature_b=8, global_feature=6,
               img_H=32, img_W=32, img_fine_resolution_scale=32)
    L, N, Ma, Mb, k = 1, 10, 2, 3, 2
    macs = (N * (7 * 2 + 2 * 2 + 2 * 2) + N * (4 * 4 + 4 * 4)
            + Mb * k * (7 * 8 + 8 * 8) + Mb * k * (16 * 16 + 16 * 8)
            + Mb * (11 * 3 + 3 * 6)
            + Mb * (8 + 512) * 256 + Mb * 256 * L + Mb * L * 512
            + Mb * (8 + 6 + 512 + 512) * 1024 + Mb * 1024 * 512
            + Mb * 512 * 512
            + Ma * (4 + 512) * 256 + Ma * 256 * 4 * L + Ma * 4 * L * 256
            + Ma * (4 + 512 + 256) * 512 + Ma * 512 * 128 + Ma * 128 * 128
            + N * 3 * 512 + Ma * 3 * 512 + N * 3 * 128
            + N * (128 + 512 + 2 + 4) * 256 + N * 256 * 256
            + N * 256 * (2 + L))
    want = 2 * (2.0 * macs + counts.resnet34_flops(32, 32))
    assert counts.detector_forward_flops(cfg, 2) == pytest.approx(want)
