// Host ray–cell intersection for unstructured meshes (the port's copy of
// the JAX package's native/raycast.cpp, built by openmeasure_torch/_build.py
// with g++ and OpenMP, called through openmeasure_torch/native/__init__.py).
//
// Voxel grids trace on the device (ctc/raytrace.py); this caster answers the
// same query, VTK's find_cells_intersecting_line, for *unstructured* meshes.
//
// Two query modes share one uniform-grid + 3D-DDA traversal:
//
//  * trace_segments_aabb  — cells summarized by axis-aligned bounding boxes
//    (exact for hex/voxel meshes, superset for skewed elements; the
//    documented fast path).
//  * trace_segments_cells — EXACT test for tet/pyramid/wedge/hex cells given
//    by points + connectivity: the AABB slab test is only a prefilter, and a
//    candidate counts as hit iff the segment crosses one of the cell's
//    triangulated faces OR the segment midpoint lies inside the cell (parity
//    of a half-ray against the same triangle soup — the fully-contained-
//    segment case that has no face crossing).
//
// Algorithm: bin cell AABBs into a uniform grid; per ray, 3D-DDA through the
// bins, test each candidate, dedup with a per-thread visit-stamp array.
// OpenMP across rays, so the order of the hit pairs varies from run to run;
// the set does not.
//
// C API (ctypes-friendly):
//   long trace_segments_aabb(boxes[n_cells*6] (xmin,xmax,ymin,ymax,zmin,zmax),
//                            n_cells, p1s[n_rays*3], p2s[n_rays*3], n_rays,
//                            out_rays[max_hits], out_cells[max_hits],
//                            max_hits)
//   long trace_segments_cells(points[n_pts*3], n_pts,
//                             cells[n_cells*k], n_cells, k,
//                             p1s[n_rays*3], p2s[n_rays*3], n_rays,
//                             out_rays[max_hits], out_cells[max_hits],
//                             max_hits)
//   both return the number of (ray, cell) hit pairs written, or -(needed) if
//   max_hits was too small; trace_segments_cells returns -1000000000 - k for
//   an unsupported vertex count k.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

struct Grid {
    double lo[3], inv_cell[3];
    int dims[3];
    std::vector<std::vector<int32_t>> bins;

    int bin_index(int ix, int iy, int iz) const {
        return ix + dims[0] * (iy + dims[1] * iz);
    }
};

inline int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

bool segment_hits_aabb(const double* p1, const double* dir, double t0,
                       double t1, const double* box) {
    // slab test on [t0, t1]
    for (int a = 0; a < 3; ++a) {
        const double lo = box[2 * a], hi = box[2 * a + 1];
        if (std::fabs(dir[a]) < 1e-300) {
            if (p1[a] < lo || p1[a] > hi) return false;
            continue;
        }
        double ta = (lo - p1[a]) / dir[a];
        double tb = (hi - p1[a]) / dir[a];
        if (ta > tb) std::swap(ta, tb);
        t0 = std::max(t0, ta);
        t1 = std::min(t1, tb);
        if (t0 > t1) return false;
    }
    return true;
}

// ------------------------------------------------------------------ //
// Exact cell tests (triangulated faces, VTK cell orderings)
// ------------------------------------------------------------------ //

// Face triangulations per vertex count (VTK vertex orderings), stored as
// flat triples.  Each quad face of the wedge and the hexahedron is split
// along the diagonal from the first vertex of its first triangle; the
// pyramid's base quad (0, 1, 2, 3) is split along its (1, 3) diagonal,
// into (3, 2, 1) and (3, 1, 0).
static const int TET_TRIS[] = {0, 1, 3, 1, 2, 3, 2, 0, 3, 0, 2, 1};
static const int PYR_TRIS[] = {0, 1, 4, 1, 2, 4, 2, 3, 4, 3, 0, 4,
                               3, 2, 1, 3, 1, 0};
static const int WEDGE_TRIS[] = {0, 1, 2, 3, 5, 4,
                                 0, 3, 4, 0, 4, 1,
                                 1, 4, 5, 1, 5, 2,
                                 2, 5, 3, 2, 3, 0};
static const int HEX_TRIS[] = {0, 1, 5, 0, 5, 4,   // x faces pairs
                               1, 2, 6, 1, 6, 5,
                               2, 3, 7, 2, 7, 6,
                               3, 0, 4, 3, 4, 7,
                               0, 3, 2, 0, 2, 1,   // bottom
                               4, 5, 6, 4, 6, 7};  // top

bool tris_for(long k, const int** tris, int* n_tris) {
    switch (k) {
        case 4: *tris = TET_TRIS; *n_tris = 4; return true;
        case 5: *tris = PYR_TRIS; *n_tris = 6; return true;
        case 6: *tris = WEDGE_TRIS; *n_tris = 8; return true;
        case 8: *tris = HEX_TRIS; *n_tris = 12; return true;
        default: return false;
    }
}

// Möller–Trumbore segment/triangle test on t in [tlo, thi].  Inclusive
// boundaries with a small barycentric epsilon so edge/vertex grazes count
// as hits (VTK's tolerance-positive convention; the numpy version in
// ctc/unstructured.py uses the identical form).
inline bool seg_tri(const double* o, const double* d, double tlo, double thi,
                    const double* v0, const double* v1, const double* v2) {
    const double EPS = 1e-12;
    double e1[3] = {v1[0] - v0[0], v1[1] - v0[1], v1[2] - v0[2]};
    double e2[3] = {v2[0] - v0[0], v2[1] - v0[1], v2[2] - v0[2]};
    double pv[3] = {d[1] * e2[2] - d[2] * e2[1],
                    d[2] * e2[0] - d[0] * e2[2],
                    d[0] * e2[1] - d[1] * e2[0]};
    double det = e1[0] * pv[0] + e1[1] * pv[1] + e1[2] * pv[2];
    if (std::fabs(det) < 1e-300) return false;       // parallel
    double inv = 1.0 / det;
    double tv[3] = {o[0] - v0[0], o[1] - v0[1], o[2] - v0[2]};
    double u = (tv[0] * pv[0] + tv[1] * pv[1] + tv[2] * pv[2]) * inv;
    if (u < -EPS || u > 1.0 + EPS) return false;
    double qv[3] = {tv[1] * e1[2] - tv[2] * e1[1],
                    tv[2] * e1[0] - tv[0] * e1[2],
                    tv[0] * e1[1] - tv[1] * e1[0]};
    double v = (d[0] * qv[0] + d[1] * qv[1] + d[2] * qv[2]) * inv;
    if (v < -EPS || u + v > 1.0 + EPS) return false;
    double t = (e2[0] * qv[0] + e2[1] * qv[1] + e2[2] * qv[2]) * inv;
    return t >= tlo - EPS && t <= thi + EPS;
}

// Exact segment-vs-cell: face crossing OR midpoint containment (parity of
// a +x ray against the cell's closed triangle surface).
bool segment_hits_cell(const double* p1, const double* dir,
                       const double* points, const int64_t* conn,
                       const int* tris, int n_tris) {
    const double* V[8];
    // conn holds this cell's vertex ids; gather vertex pointers lazily
    for (int i = 0; i < 8; ++i) V[i] = nullptr;
    auto vert = [&](int local) {
        if (!V[local]) V[local] = points + 3 * conn[local];
        return V[local];
    };
    for (int f = 0; f < n_tris; ++f) {
        const int* t = tris + 3 * f;
        if (seg_tri(p1, dir, 0.0, 1.0, vert(t[0]), vert(t[1]), vert(t[2])))
            return true;
    }
    // no face crossing: either fully inside or fully outside — parity of
    // a half-ray from the segment midpoint.  The direction is a fixed
    // GENERIC (irrational-component) vector, not +x: on axis-aligned /
    // regular meshes an axis ray from a symmetric midpoint passes
    // exactly through a quad-face diagonal, the EPS-inclusive triangle
    // test counts BOTH split triangles, and the even parity reports a
    // contained segment as a miss (the unit hex's center shows it).  Must
    // stay identical to the numpy version (_segment_hits_cells_numpy in
    // ctc/unstructured.py).
    double mid[3] = {p1[0] + 0.5 * dir[0], p1[1] + 0.5 * dir[1],
                     p1[2] + 0.5 * dir[2]};
    double dx[3] = {1.0, 0.0577350269189626, 0.0339887498948482};
    int crossings = 0;
    for (int f = 0; f < n_tris; ++f) {
        const int* t = tris + 3 * f;
        if (seg_tri(mid, dx, 0.0, 1e300, vert(t[0]), vert(t[1]), vert(t[2])))
            ++crossings;
    }
    return (crossings & 1) != 0;
}

// ------------------------------------------------------------------ //
// Shared traversal core
// ------------------------------------------------------------------ //

template <class HitTest>
long trace_core(const double* boxes, long n_cells, const double* p1s,
                const double* p2s, long n_rays, int64_t* out_rays,
                int64_t* out_cells, long max_hits, HitTest&& hit) {
    if (n_cells <= 0 || n_rays <= 0) return 0;

    // --- build the uniform grid over the mesh bounds ---
    Grid g;
    double hi[3];
    for (int a = 0; a < 3; ++a) {
        g.lo[a] = boxes[2 * a];
        hi[a] = boxes[2 * a + 1];
    }
    for (long c = 1; c < n_cells; ++c) {
        for (int a = 0; a < 3; ++a) {
            g.lo[a] = std::min(g.lo[a], boxes[6 * c + 2 * a]);
            hi[a] = std::max(hi[a], boxes[6 * c + 2 * a + 1]);
        }
    }
    const int target = std::max(1, (int)std::cbrt((double)n_cells));
    for (int a = 0; a < 3; ++a) {
        double span = std::max(hi[a] - g.lo[a], 1e-12);
        g.dims[a] = std::min(std::max(target, 1), 256);
        g.inv_cell[a] = g.dims[a] / span;
    }
    g.bins.resize((size_t)g.dims[0] * g.dims[1] * g.dims[2]);
    for (long c = 0; c < n_cells; ++c) {
        int b0[3], b1[3];
        for (int a = 0; a < 3; ++a) {
            b0[a] = clampi((int)((boxes[6 * c + 2 * a] - g.lo[a])
                                 * g.inv_cell[a]), 0, g.dims[a] - 1);
            b1[a] = clampi((int)((boxes[6 * c + 2 * a + 1] - g.lo[a])
                                 * g.inv_cell[a]), 0, g.dims[a] - 1);
        }
        for (int iz = b0[2]; iz <= b1[2]; ++iz)
            for (int iy = b0[1]; iy <= b1[1]; ++iy)
                for (int ix = b0[0]; ix <= b1[0]; ++ix)
                    g.bins[g.bin_index(ix, iy, iz)].push_back((int32_t)c);
    }

    // --- trace rays (OpenMP), collect into per-thread buffers ---
    int n_threads = 1;
#ifdef _OPENMP
    n_threads = omp_get_max_threads();
#endif
    std::vector<std::vector<int64_t>> t_rays(n_threads), t_cells(n_threads);

#pragma omp parallel
    {
        int tid = 0;
#ifdef _OPENMP
        tid = omp_get_thread_num();
#endif
        std::vector<int64_t> stamp((size_t)n_cells, -1);
        auto& my_rays = t_rays[tid];
        auto& my_cells = t_cells[tid];

#pragma omp for schedule(dynamic, 16)
        for (long r = 0; r < n_rays; ++r) {
            const double* p1 = p1s + 3 * r;
            const double* p2 = p2s + 3 * r;
            double dir[3] = {p2[0] - p1[0], p2[1] - p1[1], p2[2] - p1[2]};

            // clip the segment to the grid AABB
            double t0 = 0.0, t1 = 1.0;
            bool miss = false;
            for (int a = 0; a < 3; ++a) {
                double glo = g.lo[a];
                double ghi = g.lo[a] + g.dims[a] / g.inv_cell[a];
                if (std::fabs(dir[a]) < 1e-300) {
                    if (p1[a] < glo || p1[a] > ghi) { miss = true; break; }
                    continue;
                }
                double ta = (glo - p1[a]) / dir[a];
                double tb = (ghi - p1[a]) / dir[a];
                if (ta > tb) std::swap(ta, tb);
                t0 = std::max(t0, ta);
                t1 = std::min(t1, tb);
                if (t0 > t1) { miss = true; break; }
            }
            if (miss) continue;

            // DDA through grid bins
            double pe[3];
            int vox[3], step[3];
            double tmax[3], tdelta[3];
            for (int a = 0; a < 3; ++a) {
                pe[a] = p1[a] + (t0 + 1e-12) * dir[a];
                vox[a] = clampi((int)((pe[a] - g.lo[a]) * g.inv_cell[a]),
                                0, g.dims[a] - 1);
                if (dir[a] > 0) step[a] = 1;
                else if (dir[a] < 0) step[a] = -1;
                else step[a] = 0;
                if (step[a] != 0) {
                    double bound = g.lo[a] + (vox[a] + (step[a] > 0 ? 1 : 0))
                                   / g.inv_cell[a];
                    tmax[a] = (bound - p1[a]) / dir[a];
                    tdelta[a] = std::fabs(1.0 / (g.inv_cell[a] * dir[a]));
                } else {
                    tmax[a] = 1e300;
                    tdelta[a] = 1e300;
                }
            }

            while (true) {
                const auto& bin = g.bins[g.bin_index(vox[0], vox[1], vox[2])];
                for (int32_t c : bin) {
                    if (stamp[(size_t)c] == r) continue;
                    if (segment_hits_aabb(p1, dir, t0, t1, boxes + 6 * c)) {
                        stamp[(size_t)c] = r;   // AABB-tested once per ray
                        if (hit(c, p1, dir)) {
                            my_rays.push_back(r);
                            my_cells.push_back(c);
                        }
                    }
                }
                int axis = 0;
                if (tmax[1] < tmax[axis]) axis = 1;
                if (tmax[2] < tmax[axis]) axis = 2;
                if (tmax[axis] > t1) break;
                vox[axis] += step[axis];
                if (vox[axis] < 0 || vox[axis] >= g.dims[axis]) break;
                tmax[axis] += tdelta[axis];
            }
        }
    }

    // --- gather ---
    long total = 0;
    for (int t = 0; t < n_threads; ++t) total += (long)t_rays[t].size();
    if (total > max_hits) return -total;
    long off = 0;
    for (int t = 0; t < n_threads; ++t) {
        std::memcpy(out_rays + off, t_rays[t].data(),
                    t_rays[t].size() * sizeof(int64_t));
        std::memcpy(out_cells + off, t_cells[t].data(),
                    t_cells[t].size() * sizeof(int64_t));
        off += (long)t_rays[t].size();
    }
    return total;
}

}  // namespace

extern "C" {

long trace_segments_aabb(const double* boxes, long n_cells,
                         const double* p1s, const double* p2s, long n_rays,
                         int64_t* out_rays, int64_t* out_cells,
                         long max_hits) {
    return trace_core(boxes, n_cells, p1s, p2s, n_rays, out_rays, out_cells,
                      max_hits,
                      [](int32_t, const double*, const double*) {
                          return true;  // the AABB slab test IS the test
                      });
}

long trace_segments_cells(const double* points, long n_pts,
                          const int64_t* cells, long n_cells, long k,
                          const double* p1s, const double* p2s, long n_rays,
                          int64_t* out_rays, int64_t* out_cells,
                          long max_hits) {
    (void)n_pts;
    const int* tris;
    int n_tris;
    if (!tris_for(k, &tris, &n_tris)) return -1000000000 - k;

    // cell AABBs from the vertices (prefilter grid)
    std::vector<double> boxes((size_t)n_cells * 6);
    for (long c = 0; c < n_cells; ++c) {
        double lo[3] = {1e300, 1e300, 1e300};
        double hi[3] = {-1e300, -1e300, -1e300};
        for (long j = 0; j < k; ++j) {
            const double* p = points + 3 * cells[c * k + j];
            for (int a = 0; a < 3; ++a) {
                lo[a] = std::min(lo[a], p[a]);
                hi[a] = std::max(hi[a], p[a]);
            }
        }
        for (int a = 0; a < 3; ++a) {
            boxes[6 * c + 2 * a] = lo[a];
            boxes[6 * c + 2 * a + 1] = hi[a];
        }
    }

    return trace_core(boxes.data(), n_cells, p1s, p2s, n_rays, out_rays,
                      out_cells, max_hits,
                      [&](int32_t c, const double* p1, const double* dir) {
                          return segment_hits_cell(
                              p1, dir, points, cells + (long)c * k, tris,
                              n_tris);
                      });
}

}  // extern "C"
