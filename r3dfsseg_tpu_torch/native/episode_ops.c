/* Native episode-assembly kernel for the host data path (a copy of
 * r3dfsseg_tpu/native/episode_ops.c).
 *
 * The reference's host hot loop (`dataloaders/loader.py:
 * 138-373`) assembles every shot with ~15 chained numpy kernels (gather,
 * min-shift, augmentation matmul, jitter add/clip, rgb scale, XYZ
 * normalise, label compares) over float64 temporaries; torch's C++
 * DataLoader workers hide that cost on the reference's side.  Here the
 * whole per-scan transform is ONE C pass over the selected rows.
 *
 * Randomness (point choice, augmentation matrix, jitter draws) stays in
 * numpy on the Python side so the native and numpy paths consume an
 * identical RNG stream and produce identical episodes.
 *
 * Built with `cc -O3 -shared -fPIC` by r3dfsseg_tpu_torch/native/__init__.py and
 * called through ctypes (no numpy C API / pybind dependency).
 */
#include <stddef.h>
#include <stdint.h>

/* Assemble one scan.
 *
 * data:    (n_rows, n_cols) float64, C-contiguous scan; columns
 *          0-2 xyz, 3-5 rgb, 6 semantic label, last column instance id.
 * idx:     (num_point,) int64 selected rows.
 * aug_m:   3x3 float64 row-major augmentation matrix or NULL.
 * jitter:  (num_point, 3) float64 pre-drawn clipped jitter or NULL.
 * use_*:   attribute selection ('xyz' | 'rgb' | 'XYZ' substrings).
 * classes: episode classes (for query label remap, loader.py:231-237).
 * support: 1 -> binary target-class mask, 0 -> query remap.
 * cluster_col: source column for the cluster label, or -1 for zeros.
 *
 * out_pt:      (num_point, n_attr) float32.
 * out_label:   (num_point,) int64  (noisy labels, from column 6).
 * out_gt:      (num_point,) int64  (same rule on column 6 — the caller
 *              overwrites column-6 data for noisy shots upstream, so both
 *              label kinds use the same pass here).
 * out_cluster: (num_point,) int64.
 *
 * Returns the number of foreground points in out_label (the caller asserts
 * it is > 0, mirroring loader.py:322).
 */
long assemble_scan(
    const double *data, long n_rows, long n_cols,
    const int64_t *idx, long num_point,
    const double *aug_m,
    const double *jitter,
    int use_xyz, int use_rgb, int use_big_xyz,
    long sampled_class, const int64_t *classes, long n_classes, int support,
    long cluster_col,
    float *out_pt, int64_t *out_label, int64_t *out_gt, int64_t *out_cluster)
{
    (void)n_rows;
    double minx = 1e300, miny = 1e300, minz = 1e300;
    long i;

    /* pass 1: min over the selected rows' raw xyz (loader.py:204) */
    for (i = 0; i < num_point; i++) {
        const double *row = data + idx[i] * n_cols;
        if (row[0] < minx) minx = row[0];
        if (row[1] < miny) miny = row[1];
        if (row[2] < minz) minz = row[2];
    }

    /* pass 2: shift, augment, jitter -> xyz buffer; track post-augment
     * min/max for the XYZ unit-box attributes (loader.py:206-217) */
    double mn2[3] = {1e300, 1e300, 1e300};
    double mx2[3] = {-1e300, -1e300, -1e300};
    long n_attr = (use_xyz ? 3 : 0) + (use_rgb ? 3 : 0) + (use_big_xyz ? 3 : 0);
    /* xyz scratch lives in the output's first columns when present,
     * otherwise recomputed in pass 3 — keep a stack buffer per point */
    for (i = 0; i < num_point; i++) {
        const double *row = data + idx[i] * n_cols;
        double x = row[0] - minx, y = row[1] - miny, z = row[2] - minz;
        double ax = x, ay = y, az = z;
        if (aug_m) {
            ax = aug_m[0] * x + aug_m[1] * y + aug_m[2] * z;
            ay = aug_m[3] * x + aug_m[4] * y + aug_m[5] * z;
            az = aug_m[6] * x + aug_m[7] * y + aug_m[8] * z;
        }
        if (jitter) {
            ax += jitter[3 * i];
            ay += jitter[3 * i + 1];
            az += jitter[3 * i + 2];
        }
        /* stash augmented xyz in the first three output columns (f32 would
         * lose bits for the XYZ normalisation, so keep doubles in a side
         * accumulation: store now, normalise in pass 3 from the stored
         * values' double originals — f32 storage is what the numpy path
         * emits too, but IT normalises from float64; replicate that by
         * recomputing below).  To avoid a heap buffer we run the
         * augmentation twice: once here for min/max, once in pass 3. */
        if (ax < mn2[0]) mn2[0] = ax;
        if (ay < mn2[1]) mn2[1] = ay;
        if (az < mn2[2]) mn2[2] = az;
        if (ax > mx2[0]) mx2[0] = ax;
        if (ay > mx2[1]) mx2[1] = ay;
        if (az > mx2[2]) mx2[2] = az;
    }
    double rng2[3];
    for (i = 0; i < 3; i++) {
        rng2[i] = mx2[i] - mn2[i];
        /* no degenerate-axis guard: a zero range divides to inf/nan in
         * IEEE, exactly like the numpy path (sampler.py XYZ normalise) —
         * the two paths must stay bit-identical */
    }

    long fg = 0;
    for (i = 0; i < num_point; i++) {
        const double *row = data + idx[i] * n_cols;
        double x = row[0] - minx, y = row[1] - miny, z = row[2] - minz;
        double ax = x, ay = y, az = z;
        if (aug_m) {
            ax = aug_m[0] * x + aug_m[1] * y + aug_m[2] * z;
            ay = aug_m[3] * x + aug_m[4] * y + aug_m[5] * z;
            az = aug_m[6] * x + aug_m[7] * y + aug_m[8] * z;
        }
        if (jitter) {
            ax += jitter[3 * i];
            ay += jitter[3 * i + 1];
            az += jitter[3 * i + 2];
        }
        float *o = out_pt + i * n_attr;
        if (use_xyz) {
            o[0] = (float)ax; o[1] = (float)ay; o[2] = (float)az;
            o += 3;
        }
        if (use_rgb) {
            o[0] = (float)(row[3] / 255.0);
            o[1] = (float)(row[4] / 255.0);
            o[2] = (float)(row[5] / 255.0);
            o += 3;
        }
        if (use_big_xyz) {
            o[0] = (float)((ax - mn2[0]) / rng2[0]);
            o[1] = (float)((ay - mn2[1]) / rng2[1]);
            o[2] = (float)((az - mn2[2]) / rng2[2]);
        }

        long lbl = (long)row[6];
        int64_t g;
        if (support) {
            g = (lbl == sampled_class) ? 1 : 0;
        } else {
            g = 0;
            for (long c = 0; c < n_classes; c++) {
                if (lbl == classes[c]) { g = c + 1; break; }
            }
        }
        out_label[i] = g;
        out_gt[i] = g;
        if (g > 0) fg++;
        out_cluster[i] = (cluster_col >= 0) ? (int64_t)row[cluster_col] : 0;
    }
    return fg;
}
