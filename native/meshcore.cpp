// meshcore: native host-side mesh engine for bemstokes_tpu.
//
// The reference's runtime is C++ end-to-end (deal.II GridIn readers,
// Triangulation topology, METIS partitioning).  Here the device compute is
// JAX/XLA, but the host-side mesh machinery — file parsing, vertex welding,
// topology/incidence tables — stays latency-bound CPU work on the frame
// loop's critical path (a new gait mesh is read EVERY frame, reference
// `compute_euler_vector` -> `read_input_mesh_file`,
// `source/bem_stokes.cc:2247-2440, 497-523`).  This library implements that
// layer natively; bemstokes_tpu._native binds it via ctypes with a pure
// numpy fallback.
//
// Exposed C ABI (all buffers are malloc'd here and released with mc_free):
//   mc_read_msh / mc_read_inp : parse gmsh v1/v2 / AVS-UCD surface meshes
//   mc_incidence              : node -> (cell, local) slot lists (assembly tables)
//   mc_weld                   : merge coincident vertices (wall/box attachment)
//
// Build: make -C native   (g++ -O3 -shared -fPIC meshcore.cpp -o libmeshcore.so)

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <string>
#include <unordered_map>
#include <vector>

extern "C" {

struct MeshBuf {
  double *verts;      // [n_verts * 3]
  int64_t n_verts;
  int32_t *cells;     // [n_cells * nl]
  int64_t n_cells;
  int32_t nl;         // nodes per cell (4 = quad, 2 = line)
  int32_t *mat;       // [n_cells]
};

void mc_free(void *p) { std::free(p); }

void mc_free_mesh(MeshBuf *m) {
  std::free(m->verts);
  std::free(m->cells);
  std::free(m->mat);
  m->verts = nullptr;
  m->cells = nullptr;
  m->mat = nullptr;
}

}  // extern "C"

namespace {

// read whole file into a string (faster than iostream line loops)
static bool slurp(const char *path, std::string &out) {
  FILE *f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long sz = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  out.resize((size_t)sz);
  size_t rd = std::fread(out.data(), 1, (size_t)sz, f);
  std::fclose(f);
  return rd == (size_t)sz;
}

struct Tok {
  const char *p, *end;
  explicit Tok(const std::string &s) : p(s.data()), end(s.data() + s.size()) {}
  bool next(const char *&t0, const char *&t1) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r' || *p == '\n')) ++p;
    if (p >= end) return false;
    t0 = p;
    while (p < end && !(*p == ' ' || *p == '\t' || *p == '\r' || *p == '\n')) ++p;
    t1 = p;
    return true;
  }
  bool next_str(std::string &s) {
    const char *a, *b;
    if (!next(a, b)) return false;
    s.assign(a, b);
    return true;
  }
  bool next_i64(int64_t &v) {
    const char *a, *b;
    if (!next(a, b)) return false;
    v = std::strtoll(a, nullptr, 10);
    return true;
  }
  bool next_f64(double &v) {
    const char *a, *b;
    if (!next(a, b)) return false;
    v = std::strtod(a, nullptr);
    return true;
  }
  // skip to the line after the current position (for section payloads kept
  // token-based this is unused; msh/inp are fully token-separable)
};

static MeshBuf pack(const std::vector<double> &verts,
                    const std::vector<int32_t> &cells,
                    const std::vector<int32_t> &mats, int32_t nl) {
  MeshBuf m;
  m.n_verts = (int64_t)verts.size() / 3;
  m.n_cells = nl ? (int64_t)cells.size() / nl : 0;
  m.nl = nl;
  m.verts = (double *)std::malloc(verts.size() * sizeof(double));
  m.cells = (int32_t *)std::malloc(cells.size() * sizeof(int32_t));
  m.mat = (int32_t *)std::malloc(mats.size() * sizeof(int32_t));
  std::memcpy(m.verts, verts.data(), verts.size() * sizeof(double));
  std::memcpy(m.cells, cells.data(), cells.size() * sizeof(int32_t));
  std::memcpy(m.mat, mats.data(), mats.size() * sizeof(int32_t));
  return m;
}

}  // namespace

extern "C" {

// dim==3 keeps 4-node quads (ccw -> lexicographic), dim==2 keeps 2-node
// lines; matches bemstokes_tpu.mesh.io.read_msh semantics exactly.
int mc_read_msh(const char *path, int32_t dim, MeshBuf *out) {
  std::string buf;
  if (!slurp(path, buf)) return -1;
  Tok tok(buf);
  std::string t;
  std::vector<double> verts;
  std::vector<int64_t> node_ids;
  std::unordered_map<int64_t, int32_t> id_map;
  std::vector<int32_t> cells, mats;
  const int32_t nl = dim == 3 ? 4 : 2;
  const int want_etype = dim == 3 ? 3 /*quad*/ : 1 /*line*/;

  while (tok.next_str(t)) {
    if (t == "$NOD" || t == "$Nodes") {
      int64_t n;
      if (!tok.next_i64(n)) return -2;
      verts.reserve((size_t)n * 3);
      for (int64_t k = 0; k < n; ++k) {
        int64_t id;
        double x, y, z;
        if (!tok.next_i64(id) || !tok.next_f64(x) || !tok.next_f64(y) ||
            !tok.next_f64(z))
          return -2;
        id_map.emplace(id, (int32_t)node_ids.size());
        node_ids.push_back(id);
        verts.push_back(x);
        verts.push_back(y);
        verts.push_back(z);
      }
    } else if (t == "$ELM" || t == "$Elements") {
      const bool v2 = (t == "$Elements");
      int64_t n;
      if (!tok.next_i64(n)) return -3;
      for (int64_t k = 0; k < n; ++k) {
        int64_t id, etype, phys = 0, nnodes;
        if (!tok.next_i64(id) || !tok.next_i64(etype)) return -3;
        if (v2) {
          int64_t ntags;
          if (!tok.next_i64(ntags)) return -3;
          for (int64_t j = 0; j < ntags; ++j) {
            int64_t tag;
            if (!tok.next_i64(tag)) return -3;
            if (j == 0) phys = tag;
          }
          nnodes = etype == 3 ? 4 : etype == 1 ? 2 : etype == 15 ? 1 : -1;
          if (nnodes < 0) return -4;  // unsupported element type
        } else {
          int64_t reg, nn;
          if (!tok.next_i64(phys) || !tok.next_i64(reg) || !tok.next_i64(nn))
            return -3;
          nnodes = nn;
        }
        int64_t nd[8];
        for (int64_t j = 0; j < nnodes; ++j)
          if (!tok.next_i64(nd[j])) return -3;
        if (etype == want_etype) {
          if (dim == 3) {
            // ccw -> lexicographic
            cells.push_back(id_map.at(nd[0]));
            cells.push_back(id_map.at(nd[1]));
            cells.push_back(id_map.at(nd[3]));
            cells.push_back(id_map.at(nd[2]));
          } else {
            cells.push_back(id_map.at(nd[0]));
            cells.push_back(id_map.at(nd[1]));
          }
          mats.push_back((int32_t)phys);
        }
      }
    }
  }
  *out = pack(verts, cells, mats, nl);
  return 0;
}

int mc_read_inp(const char *path, int32_t dim, MeshBuf *out) {
  std::string buf;
  if (!slurp(path, buf)) return -1;
  Tok tok(buf);
  int64_t n_nodes, n_cells, a, b, c;
  if (!tok.next_i64(n_nodes) || !tok.next_i64(n_cells) || !tok.next_i64(a) ||
      !tok.next_i64(b) || !tok.next_i64(c))
    return -2;
  std::vector<double> verts;
  verts.reserve((size_t)n_nodes * 3);
  std::unordered_map<int64_t, int32_t> id_map;
  for (int64_t k = 0; k < n_nodes; ++k) {
    int64_t id;
    double x, y, z;
    if (!tok.next_i64(id) || !tok.next_f64(x) || !tok.next_f64(y) ||
        !tok.next_f64(z))
      return -2;
    id_map.emplace(id, (int32_t)k);
    verts.push_back(x);
    verts.push_back(y);
    verts.push_back(z);
  }
  std::vector<int32_t> cells, mats;
  const int32_t nl = dim == 3 ? 4 : 2;
  std::string ctype;
  for (int64_t k = 0; k < n_cells; ++k) {
    int64_t id, mat;
    if (!tok.next_i64(id) || !tok.next_i64(mat) || !tok.next_str(ctype))
      return -3;
    int64_t nn = ctype == "quad" ? 4 : ctype == "line" ? 2 : ctype == "hex" ? 8 : -1;
    if (nn < 0) return -4;
    int64_t nd[8];
    for (int64_t j = 0; j < nn; ++j)
      if (!tok.next_i64(nd[j])) return -3;
    if ((dim == 3 && ctype == "quad") || (dim == 2 && ctype == "line")) {
      if (dim == 3) {
        cells.push_back(id_map.at(nd[0]));
        cells.push_back(id_map.at(nd[1]));
        cells.push_back(id_map.at(nd[3]));
        cells.push_back(id_map.at(nd[2]));
      } else {
        cells.push_back(id_map.at(nd[0]));
        cells.push_back(id_map.at(nd[1]));
      }
      mats.push_back((int32_t)mat);
    }
  }
  *out = pack(verts, cells, mats, nl);
  return 0;
}

// node -> incident (cell, local) flat slots (c*nl + l), padded to the max
// valence; mask marks real entries.  Mirrors build_assembly_tables
// (bemstokes_tpu/ops/assemble.py).  Caller frees *slots/*mask with mc_free.
int mc_incidence(const int32_t *cells_nodes, int64_t n_cells, int32_t nl,
                 int64_t n_nodes, int32_t **slots, double **mask,
                 int32_t *vmax_out) {
  const int64_t n_flat = n_cells * nl;
  std::vector<int32_t> counts((size_t)n_nodes, 0);
  for (int64_t s = 0; s < n_flat; ++s) {
    int32_t j = cells_nodes[s];
    if (j < 0 || j >= n_nodes) return -1;
    ++counts[(size_t)j];
  }
  int32_t vmax = 1;
  for (int64_t j = 0; j < n_nodes; ++j)
    if (counts[(size_t)j] > vmax) vmax = counts[(size_t)j];
  *slots = (int32_t *)std::calloc((size_t)(n_nodes * vmax), sizeof(int32_t));
  *mask = (double *)std::calloc((size_t)(n_nodes * vmax), sizeof(double));
  std::vector<int32_t> fill((size_t)n_nodes, 0);
  for (int64_t s = 0; s < n_flat; ++s) {
    int32_t j = cells_nodes[s];
    int64_t at = (int64_t)j * vmax + fill[(size_t)j]++;
    (*slots)[at] = (int32_t)s;
    (*mask)[at] = 1.0;
  }
  *vmax_out = vmax;
  return 0;
}

// weld coincident vertices (round to tol grid), keeping first occurrence in
// input order; writes the remap old->new and returns the new vertex count.
// Mirrors SurfaceMesh.merged_with's welding step.
int64_t mc_weld(const double *verts, int64_t n_verts, int32_t dim, double tol,
                int32_t *remap /* [n_verts] out */) {
  struct Key {
    int64_t a, b, c;
    bool operator==(const Key &o) const {
      return a == o.a && b == o.b && c == o.c;
    }
  };
  struct KeyHash {
    size_t operator()(const Key &k) const {
      uint64_t h = 1469598103934665603ull;
      auto mix = [&h](uint64_t v) {
        h ^= v;
        h *= 1099511628211ull;
      };
      mix((uint64_t)k.a);
      mix((uint64_t)k.b);
      mix((uint64_t)k.c);
      return (size_t)h;
    }
  };
  std::unordered_map<Key, int32_t, KeyHash> seen;
  seen.reserve((size_t)n_verts);
  const double inv = 1.0 / (tol > 0 ? tol : 1e-300);
  int32_t next_id = 0;
  for (int64_t i = 0; i < n_verts; ++i) {
    Key k{0, 0, 0};
    k.a = (int64_t)std::llround(verts[i * dim + 0] * inv);
    if (dim > 1) k.b = (int64_t)std::llround(verts[i * dim + 1] * inv);
    if (dim > 2) k.c = (int64_t)std::llround(verts[i * dim + 2] * inv);
    auto it = seen.find(k);
    if (it == seen.end()) {
      seen.emplace(k, next_id);
      remap[i] = next_id++;
    } else {
      remap[i] = it->second;
    }
  }
  return next_id;
}

}  // extern "C"
