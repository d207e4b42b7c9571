"""The frozen work counts, worked by hand from a tiny scene's shapes."""
from ptbench import roofline


def test_frame_kernel_count_by_hand():
    # 4 x 3 pixels, 100 queries, 3 spheres, no triangles, 4 materials:
    # ops 100 x (7 + 3 x 47) = 14,800; bytes 12 x 28 + 3 x 68 + 4 x 192
    # = 336 + 204 + 768 = 1,308
    s = roofline.frame_kernel_s(pixels=12, queries=100, n_tris=0, n_ell=3,
                                n_mats=4)
    assert s == max(1308 / 3.35e12, 14800 / 67e12)


def test_frame_kernel_count_with_implicits_and_rotations_by_hand():
    # 100 queries, 4 ellipsoids, 1 implicit, 2 of them rotated: ops
    # 100 x (7 + 4 x 47 + 41 + 2 x 30) = 29,600; bytes 12 x 28 + 4 x 68
    # + 5 x 192 = 336 + 272 + 960 = 1,568
    s = roofline.frame_kernel_s(pixels=12, queries=100, n_tris=0, n_ell=4,
                                n_imp=1, n_rot=2, n_mats=5)
    assert s == max(1568 / 3.35e12, 29600 / 67e12)


def test_bounce_kernel_count_by_hand():
    # 2 frames of 6 pixels, 2 spp: 24 paths, 50 queries; misses 24, hits
    # 26: path 50 x 68 + 24 x 25 + 26 x 98 = 3,400 + 600 + 2,548 = 6,548;
    # camera 2 x 6 x (130 + 158) = 3,456
    s = roofline.bounce_kernel_s(queries=50, paths=24, pixels=6, spp=2,
                                 frames=2)
    assert s == (6548 + 3456) / 3.35e12


def test_fewer_queries_than_paths_all_miss():
    s = roofline.bounce_kernel_s(queries=10, paths=24, pixels=12, spp=1,
                                 frames=2, perm=False)
    assert s == (10 * 68 + 10 * 25 + 2 * 12 * 130) / 3.35e12


def test_streamed_kernel_count_by_hand():
    assert roofline.streamed_kernel_s(queries=1000) == 44000 / 3.35e12
