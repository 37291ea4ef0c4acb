// Native mesh preprocessing ops for the garment data loader.
//
// Replaces the reference's libigl surface (read_triangle_mesh,
// random_points_on_mesh, snap_points — nn/data/datasets.py:832-888) with a
// self-contained C++ implementation exposed through a C ABI (loaded via
// ctypes, no pybind11 needed):
//   * obj parsing (vertices + triangulated faces, polygon fan-split)
//   * area-weighted barycentric surface sampling (counter-based RNG, so a
//     (seed, sample-index) pair always yields the same point)
//   * nearest-vertex snap with a uniform-grid accelerator
//
// Build: g++ -O3 -march=native -shared -fPIC mesh_ops.cpp -o libmesh_ops.so

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>

extern "C" {

// ----------------------------------------------------------------------
// OBJ parsing
// ----------------------------------------------------------------------

struct ObjMesh {
    double* verts;   // [n_verts * 3]
    int64_t* faces;  // [n_faces * 3]
    int64_t n_verts;
    int64_t n_faces;
};

// Parse only 'v' and 'f' records; polygons are fan-triangulated; negative and
// 'v/vt/vn' style indices are handled.
ObjMesh* obj_parse(const char* path) {
    FILE* fp = std::fopen(path, "rb");
    if (!fp) return nullptr;

    std::fseek(fp, 0, SEEK_END);
    long size = std::ftell(fp);
    std::fseek(fp, 0, SEEK_SET);
    std::vector<char> buf(static_cast<size_t>(size) + 1);
    if (std::fread(buf.data(), 1, size, fp) != static_cast<size_t>(size)) {
        std::fclose(fp);
        return nullptr;
    }
    std::fclose(fp);
    buf[size] = '\0';

    std::vector<double> verts;
    std::vector<int64_t> faces;
    verts.reserve(1 << 14);
    faces.reserve(1 << 15);

    char* p = buf.data();
    char* end = buf.data() + size;
    while (p < end) {
        // find line end
        char* line_end = static_cast<char*>(std::memchr(p, '\n', end - p));
        if (!line_end) line_end = end;
        *line_end = '\0';

        if (p[0] == 'v' && (p[1] == ' ' || p[1] == '\t')) {
            char* cursor = p + 2;
            double x = std::strtod(cursor, &cursor);
            double y = std::strtod(cursor, &cursor);
            double z = std::strtod(cursor, &cursor);
            verts.push_back(x);
            verts.push_back(y);
            verts.push_back(z);
        } else if (p[0] == 'f' && (p[1] == ' ' || p[1] == '\t')) {
            int64_t idx[64];
            int n = 0;
            char* cursor = p + 2;
            while (*cursor && n < 64) {
                while (*cursor == ' ' || *cursor == '\t') ++cursor;
                if (!*cursor) break;
                long v = std::strtol(cursor, &cursor, 10);
                if (v == 0) break;
                int64_t nv = static_cast<int64_t>(verts.size() / 3);
                idx[n++] = v > 0 ? v - 1 : nv + v;
                // skip /vt/vn attachments
                while (*cursor && *cursor != ' ' && *cursor != '\t') ++cursor;
            }
            for (int i = 2; i < n; ++i) {  // fan triangulation
                faces.push_back(idx[0]);
                faces.push_back(idx[i - 1]);
                faces.push_back(idx[i]);
            }
        }
        p = line_end + 1;
    }

    ObjMesh* mesh = new ObjMesh();
    mesh->n_verts = static_cast<int64_t>(verts.size() / 3);
    mesh->n_faces = static_cast<int64_t>(faces.size() / 3);
    mesh->verts = static_cast<double*>(std::malloc(verts.size() * sizeof(double)));
    mesh->faces = static_cast<int64_t*>(std::malloc(faces.size() * sizeof(int64_t)));
    std::memcpy(mesh->verts, verts.data(), verts.size() * sizeof(double));
    std::memcpy(mesh->faces, faces.data(), faces.size() * sizeof(int64_t));
    return mesh;
}

void obj_free(ObjMesh* mesh) {
    if (!mesh) return;
    std::free(mesh->verts);
    std::free(mesh->faces);
    delete mesh;
}

int64_t obj_n_verts(ObjMesh* m) { return m->n_verts; }
int64_t obj_n_faces(ObjMesh* m) { return m->n_faces; }
void obj_copy_verts(ObjMesh* m, double* out) { std::memcpy(out, m->verts, m->n_verts * 3 * sizeof(double)); }
void obj_copy_faces(ObjMesh* m, int64_t* out) { std::memcpy(out, m->faces, m->n_faces * 3 * sizeof(int64_t)); }

// ----------------------------------------------------------------------
// Counter-based RNG (splitmix64) -> double in [0, 1)
// ----------------------------------------------------------------------

static inline uint64_t splitmix64(uint64_t x) {
    x += 0x9e3779b97f4a7c15ULL;
    x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
    x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
    return x ^ (x >> 31);
}

static inline double rng_uniform(uint64_t seed, uint64_t counter) {
    return static_cast<double>(splitmix64(seed ^ splitmix64(counter)) >> 11)
           * (1.0 / 9007199254740992.0);  // 2^53
}

// ----------------------------------------------------------------------
// Area-weighted surface sampling
// ----------------------------------------------------------------------

// Samples `n_points` points on the triangle mesh; writes world coordinates to
// `out_points` [n_points * 3]. Deterministic in (seed, point index).
void sample_surface(const double* verts, int64_t n_verts,
                    const int64_t* faces, int64_t n_faces,
                    int64_t n_points, uint64_t seed, double* out_points) {
    (void)n_verts;
    // cumulative areas
    std::vector<double> cum_area(n_faces);
    double total = 0.0;
    for (int64_t f = 0; f < n_faces; ++f) {
        const double* a = verts + faces[f * 3 + 0] * 3;
        const double* b = verts + faces[f * 3 + 1] * 3;
        const double* c = verts + faces[f * 3 + 2] * 3;
        double ab[3] = {b[0] - a[0], b[1] - a[1], b[2] - a[2]};
        double ac[3] = {c[0] - a[0], c[1] - a[1], c[2] - a[2]};
        double cx = ab[1] * ac[2] - ab[2] * ac[1];
        double cy = ab[2] * ac[0] - ab[0] * ac[2];
        double cz = ab[0] * ac[1] - ab[1] * ac[0];
        total += 0.5 * std::sqrt(cx * cx + cy * cy + cz * cz);
        cum_area[f] = total;
    }

    for (int64_t i = 0; i < n_points; ++i) {
        double r = rng_uniform(seed, 3 * i) * total;
        int64_t f = static_cast<int64_t>(
            std::lower_bound(cum_area.begin(), cum_area.end(), r) - cum_area.begin());
        if (f >= n_faces) f = n_faces - 1;

        double u = rng_uniform(seed, 3 * i + 1);
        double v = rng_uniform(seed, 3 * i + 2);
        if (u + v > 1.0) { u = 1.0 - u; v = 1.0 - v; }  // fold into the triangle
        double w = 1.0 - u - v;

        const double* a = verts + faces[f * 3 + 0] * 3;
        const double* b = verts + faces[f * 3 + 1] * 3;
        const double* c = verts + faces[f * 3 + 2] * 3;
        out_points[i * 3 + 0] = w * a[0] + u * b[0] + v * c[0];
        out_points[i * 3 + 1] = w * a[1] + u * b[1] + v * c[1];
        out_points[i * 3 + 2] = w * a[2] + u * b[2] + v * c[2];
    }
}

// ----------------------------------------------------------------------
// Nearest-vertex snap (uniform grid accelerator)
// ----------------------------------------------------------------------

struct Grid {
    double low[3];
    double cell;
    int dims[3];
    std::vector<std::vector<int64_t>> cells;

    inline int clampi(int v, int hi) const { return v < 0 ? 0 : (v >= hi ? hi - 1 : v); }
    inline int cell_of(const double* p) const {
        int ix = clampi(static_cast<int>((p[0] - low[0]) / cell), dims[0]);
        int iy = clampi(static_cast<int>((p[1] - low[1]) / cell), dims[1]);
        int iz = clampi(static_cast<int>((p[2] - low[2]) / cell), dims[2]);
        return (ix * dims[1] + iy) * dims[2] + iz;
    }
};

// For every query point, writes the index of (and squared distance to) the
// nearest target point.
void snap_points(const double* queries, int64_t n_queries,
                 const double* targets, int64_t n_targets,
                 int64_t* out_idx, double* out_sq_dist) {
    if (n_targets == 0) return;

    Grid grid;
    double high[3];
    for (int d = 0; d < 3; ++d) { grid.low[d] = targets[d]; high[d] = targets[d]; }
    for (int64_t i = 1; i < n_targets; ++i)
        for (int d = 0; d < 3; ++d) {
            grid.low[d] = std::min(grid.low[d], targets[i * 3 + d]);
            high[d] = std::max(high[d], targets[i * 3 + d]);
        }
    double extent = std::max({high[0] - grid.low[0], high[1] - grid.low[1],
                              high[2] - grid.low[2], 1e-9});
    int res = std::max(1, static_cast<int>(std::cbrt(static_cast<double>(n_targets) / 4.0)));
    grid.cell = extent / res;
    for (int d = 0; d < 3; ++d) {
        grid.dims[d] = std::max(1, static_cast<int>((high[d] - grid.low[d]) / grid.cell) + 1);
    }
    grid.cells.resize(static_cast<size_t>(grid.dims[0]) * grid.dims[1] * grid.dims[2]);
    for (int64_t i = 0; i < n_targets; ++i)
        grid.cells[grid.cell_of(targets + i * 3)].push_back(i);

    for (int64_t q = 0; q < n_queries; ++q) {
        const double* p = queries + q * 3;
        double best = 1e300;
        int64_t best_idx = 0;
        int cx = grid.clampi(static_cast<int>((p[0] - grid.low[0]) / grid.cell), grid.dims[0]);
        int cy = grid.clampi(static_cast<int>((p[1] - grid.low[1]) / grid.cell), grid.dims[1]);
        int cz = grid.clampi(static_cast<int>((p[2] - grid.low[2]) / grid.cell), grid.dims[2]);

        // expand ring by ring until a hit is found and the ring distance
        // exceeds the best distance
        int max_ring = std::max({grid.dims[0], grid.dims[1], grid.dims[2]});
        for (int ring = 0; ring <= max_ring; ++ring) {
            double ring_min_dist = (ring - 1) * grid.cell;
            if (best < 1e299 && ring_min_dist > 0 && ring_min_dist * ring_min_dist > best) break;

            for (int ix = cx - ring; ix <= cx + ring; ++ix) {
                if (ix < 0 || ix >= grid.dims[0]) continue;
                for (int iy = cy - ring; iy <= cy + ring; ++iy) {
                    if (iy < 0 || iy >= grid.dims[1]) continue;
                    for (int iz = cz - ring; iz <= cz + ring; ++iz) {
                        if (iz < 0 || iz >= grid.dims[2]) continue;
                        // only the shell of the ring
                        if (ring > 0 && std::abs(ix - cx) != ring && std::abs(iy - cy) != ring
                            && std::abs(iz - cz) != ring) continue;
                        const auto& bucket =
                            grid.cells[(static_cast<size_t>(ix) * grid.dims[1] + iy) * grid.dims[2] + iz];
                        for (int64_t t : bucket) {
                            const double* tp = targets + t * 3;
                            double dx = p[0] - tp[0], dy = p[1] - tp[1], dz = p[2] - tp[2];
                            double d = dx * dx + dy * dy + dz * dz;
                            if (d < best) { best = d; best_idx = t; }
                        }
                    }
                }
            }
        }
        out_idx[q] = best_idx;
        out_sq_dist[q] = best;
    }
}

}  // extern "C"
