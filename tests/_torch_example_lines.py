"""The lines the JAX package's examples print, as `repro_torch.examples.untimed`
leaves them: times and rates, the kernels' device and the conservation
error's digits left out.  Recorded from `python examples/<name>.py` on the
CPU (JAX_PLATFORMS=cpu); `test_jax_example_still_prints_the_recorded_lines`
in `tests/test_torch_examples.py` (marked slow) reruns each example and
holds it to these lines.  No JAX import here: the card's tests read them.

`sfc_expert_placement` draws its loads with `rng.zipf`, whose draws differ
between numpy versions: its lines hold under RECORDED_NUMPY, the version
they were recorded with, and elsewhere its lines are held live against the
JAX functions on the same draws."""

RECORDED_NUMPY = "2.0.2"

EXAMPLE_LINES = {
    "quickstart": [
        '== New: uniform level-2 forest of 2 trees on 4 ranks ==',
        '   local counts: [32, 32, 32, 32] valid: True',
        '== Adapt: refine elements near the domain diagonal, 3 rounds ==',
        '   adapted: 3096 elements; valid: True',
        '== Balance: enforce 2:1 across faces ==',
        '   balanced: 3544 elements; valid: True',
        '== Partition: weight ~ 2^level (finer elements cost more) ==',
        '   per-rank load: [25328, 25328, 25328, 25328] imbalance: 1.0',
        '== Ghost layer ==',
        '   ghosts per rank: [17, 17, 17, 17]',
        '== kernels ==',
        '   encode->decode roundtrip on rank 0: True',
        '   face-0 neighbors inside root: 882 / 886',
    ],
    "amr_fractal": [
        '== paper Fig. 12 extrapolation (transfer matrix) ==',
        '   512 trees, k=7 -> level 12: 855,518,609,408 elements (paper reports 858,588,635,136; delta 0.36% from the unspecified coarse-mesh type mix)',
        '   measured k=1: 592 == analytic 592: True',
        '   measured k=2: 3,616 == analytic 3,616: True',
        '   measured k=3: 26,688 == analytic 26,688: True',
        '== paper Fig. 11: New is linear in elements, level-independent ==',
        '   level 4:     4,096 elements',
        '   level 5:    32,768 elements',
        '   level 6:   262,144 elements',
    ],
    "multitree_cube": [
        '== d=2: 2-tree cube, 2 glued tree faces ==',
        '   balance: 41 -> 56 elements; per tree [25, 16] -> [31, 25] (refinement crossed the tree faces)',
        '   ghost: 13 entries, 13 from trees the rank holds no elements of; validate(fs, gh) = True',
        '   rank-0 faces: 75 interior, 7 inter-tree, 11 domain boundary',
        '== d=3: 6-tree cube, 12 glued tree faces ==',
        '   balance: 69 -> 139 elements; per tree [29, 8, 8, 8, 8, 8] -> [43, 29, 15, 8, 15, 29] (refinement crossed the tree faces)',
        '   ghost: 34 entries, 34 from trees the rank holds no elements of; validate(fs, gh) = True',
        '   rank-0 faces: 237 interior, 69 inter-tree, 42 domain boundary',
        '== periodic 2D cube: 0 boundary faces (torus) ==',
    ],
    "fem_diffusion": [
        'adapted+balanced mesh: 1058 leaves, levels 2..4',
        'interior face pairs: 2108',
        'step   0: max u = 0.9520, conservation error < 1e-12',
        'step  20: max u = 0.6554, conservation error < 1e-12',
        'step  40: max u = 0.5771, conservation error < 1e-12',
        'conservation + decay verified',
    ],
    "sfc_expert_placement": [
        'expert load imbalance (max/mean): naive blocked 1.72 -> SFC weighted 1.19',
        'experts per device: [36, 5, 10, 11, 15, 14, 14, 8, 12, 13, 17, 25, 30, 8, 29, 9]',
        '',
        'document->rank token balancing over 32 DP ranks: imbalance 1.013 (min 112379 max 115418 tokens)',
    ],
    "serve_lm": [
        'serving qwen3-1.7b-reduced, batch=4, cache=160',
        'SFC page order (4 requests x 10 pages of 16 tokens):',
        '[[ 0  1  4  5 16 17 20 21 32 33]',
        ' [ 2  3  6  7 18 19 22 23 34 35]',
        ' [ 8  9 12 13 24 25 28 29 36 37]',
        ' [10 11 14 15 26 27 30 31 38 39]]',
        'served 10 requests, 160 decode steps',
    ],
}
