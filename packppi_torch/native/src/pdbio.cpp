// Native host runtime: PDB parsing + Shrake-Rupley SASA.
//
// The hot host-side path of the data loader. Behavior mirrors the Python
// parser in packppi_torch/structure/protein.py (itself contract-matched to
// the reference framework): ATOM+HETATM records, waters dropped,
// optional MSE->MET, non-standard residues skipped, chains in sorted id
// order, residues stable-sorted by number, global insertion-code offset,
// per-chain duplicate-number bumping, highest-occupancy altLoc wins.
//
// Chemistry tables (residue names, atom14 layouts) are passed IN from
// Python so the single source of truth stays chem_data.json.
//
// C ABI only; loaded via ctypes (no pybind11 dependency).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <map>
#include <set>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct SlotAtom {
  float x, y, z, bfac, occ = -1.f;  // occ < 0 marks "absent"
};

struct Residue {
  int restype = 0;
  int resseq = 0;
  char icode = ' ';
  int file_order = 0;
  SlotAtom slots[14];
};

// zero-allocation field helpers over the raw line buffer -------------------

inline void copy_stripped(const char* src, size_t n, char* dst) {
  size_t k = 0;
  for (size_t i = 0; i < n; ++i)
    if (src[i] != ' ') dst[k++] = src[i];
  dst[k] = '\0';
}

// fast parser for PDB's fixed-decimal numeric fields (no exponent forms)
inline double parse_float_field(const char* line, size_t line_len, size_t start,
                                size_t len, double fallback) {
  if (line_len < start + 1) return fallback;
  const char* q = line + start;
  const char* qe = q + std::min(len, line_len - start);
  while (q < qe && *q == ' ') ++q;
  if (q == qe) return fallback;
  bool neg = (*q == '-');
  if (neg || *q == '+') ++q;
  long ipart = 0;
  bool any = false;
  while (q < qe && *q >= '0' && *q <= '9') {
    ipart = ipart * 10 + (*q - '0');
    ++q;
    any = true;
  }
  double v = static_cast<double>(ipart);
  if (q < qe && *q == '.') {
    ++q;
    long frac = 0, scale = 1;
    while (q < qe && *q >= '0' && *q <= '9') {
      frac = frac * 10 + (*q - '0');
      scale *= 10;
      ++q;
      any = true;
    }
    v += static_cast<double>(frac) / static_cast<double>(scale);
  }
  if (!any) return fallback;
  return neg ? -v : v;
}

inline uint32_t pack_name(const char* stripped) {
  uint32_t k = 0;
  for (int i = 0; i < 4 && stripped[i]; ++i) k = (k << 8) | uint8_t(stripped[i]);
  return k;
}

inline bool parse_int_field(const char* line, size_t line_len, size_t start,
                            size_t len, int* out) {
  if (line_len < start + 1) return false;
  char buf[8];
  size_t n = std::min(len, line_len - start);
  memcpy(buf, line + start, n);
  buf[n] = '\0';
  char* endp;
  long v = strtol(buf, &endp, 10);
  if (endp == buf) return false;
  *out = static_cast<int>(v);
  return true;
}

}  // namespace

extern "C" {

// Parse PDB text into atom14 arrays.
//
// resnames3:   20*3 chars, residue names in restype order.
// atom14names: 20*14*4 chars, space-padded atom names per residue type.
// chain_filter: NUL-terminated string of accepted chain ids ("" = all).
//
// Output buffers sized for max_res residues. Returns residue count, or
// -(needed) if max_res is too small, -1 on error.
int ppi_parse_pdb(const char* text, long text_len, int model_idx,
                  int discard_water, int mse_to_met, int ignore_non_std,
                  const char* chain_filter, const char* resnames3,
                  const char* atom14names, int max_res, float* positions,
                  float* atom_mask, float* bfactors, int* aaindex,
                  int* residue_index, char* chain_ids) {
  // chemistry lookup tables (names packed into uint32 keys)
  std::unordered_map<uint32_t, int> res_to_idx;
  std::vector<std::unordered_map<uint32_t, int>> atom_slot(20);
  for (int r = 0; r < 20; ++r) {
    char rbuf[8];
    copy_stripped(resnames3 + 3 * r, 3, rbuf);
    res_to_idx[pack_name(rbuf)] = r;
    for (int a = 0; a < 14; ++a) {
      char buf[8];
      copy_stripped(atom14names + (r * 14 + a) * 4, 4, buf);
      if (buf[0]) atom_slot[r][pack_name(buf)] = a;
    }
  }
  std::set<char> filter;
  for (const char* c = chain_filter; *c; ++c)
    if (*c != ',') filter.insert(*c);

  // pass 1: stream ATOM records, resolving atom14 slots immediately
  // (MSE->MET and the water / non-standard filters applied at parse time,
  // which is behaviorally identical to filtering at emit time)
  std::map<char, std::vector<Residue>> chains;
  std::map<char, std::map<std::pair<int, char>, size_t>> index_of;
  int model = 0;
  bool seen_model = false;
  int order = 0;
  // fast path: atoms arrive grouped by residue
  char last_chain = '\0';
  int last_resseq = INT32_MIN;
  char last_icode = '\0';
  size_t last_slot_idx = 0;

  const char* p = text;
  const char* end = text + text_len;
  while (p < end) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    size_t len = nl ? static_cast<size_t>(nl - p) : static_cast<size_t>(end - p);
    const char* line = p;
    p = nl ? nl + 1 : end;

    if (len >= 5 && memcmp(line, "MODEL", 5) == 0) {
      if (seen_model) ++model;
      seen_model = true;
      continue;
    }
    // HETATM must be included: MSE (selenomethionine) and other modified
    // residues are deposited as HETATM; the downstream water /
    // non-standard filters drop everything else (matches the Python
    // parser and the reference's BioPython behavior)
    if (model != model_idx || len < 54 ||
        (memcmp(line, "ATOM", 4) != 0 && memcmp(line, "HETATM", 6) != 0))
      continue;

    char chain = line[21];
    if (!filter.empty() && !filter.count(chain)) continue;

    char name[8], resname[8];
    copy_stripped(line + 12, 4, name);
    copy_stripped(line + 17, 3, resname);

    bool is_mse = mse_to_met && memcmp(resname, "MSE", 4) == 0;
    if (is_mse) {
      memcpy(resname, "MET", 4);
      if (memcmp(name, "SE", 3) == 0) memcpy(name, "SD", 3);
    }
    if (discard_water && memcmp(resname, "HOH", 4) == 0) continue;
    auto ri = res_to_idx.find(pack_name(resname));
    if (ri == res_to_idx.end()) continue;  // non-standard (ignore_non_std)
    const auto& slots = atom_slot[ri->second];
    auto slot_it = slots.find(pack_name(name));
    int slot = slot_it == slots.end() ? -1 : slot_it->second;

    int resseq;
    if (!parse_int_field(line, len, 22, 4, &resseq)) continue;
    char icode = len > 26 ? line[26] : ' ';

    size_t res_idx;
    if (chain == last_chain && resseq == last_resseq && icode == last_icode) {
      res_idx = last_slot_idx;
    } else {
      auto key = std::make_pair(resseq, icode);
      auto& idx_map = index_of[chain];
      auto it = idx_map.find(key);
      if (it == idx_map.end()) {
        chains[chain].emplace_back();
        Residue& res = chains[chain].back();
        res.restype = ri->second;
        res.resseq = resseq;
        res.icode = icode;
        res.file_order = order++;
        it = idx_map.emplace(key, chains[chain].size() - 1).first;
      }
      res_idx = it->second;
      last_chain = chain;
      last_resseq = resseq;
      last_icode = icode;
      last_slot_idx = res_idx;
    }
    if (slot < 0) continue;  // atom not in this residue's atom14 set

    Residue& res = chains[chain][res_idx];
    SlotAtom& sa = res.slots[slot];
    float occ = static_cast<float>(parse_float_field(line, len, 54, 6, 1.0));
    if (sa.occ >= 0.f && occ <= sa.occ) continue;  // keep dominant altLoc
    sa.x = static_cast<float>(parse_float_field(line, len, 30, 8, NAN));
    sa.y = static_cast<float>(parse_float_field(line, len, 38, 8, NAN));
    sa.z = static_cast<float>(parse_float_field(line, len, 46, 8, NAN));
    sa.bfac = static_cast<float>(parse_float_field(line, len, 60, 6, 0.0));
    sa.occ = occ;
  }

  // pass 2: emit residues in (sorted chain, stable resseq) order
  int n = 0;
  int insertion_offset = 0;
  std::map<char, std::set<int>> used;
  std::vector<int> out_resseq;

  for (auto& [chain, residues] : chains) {
    std::stable_sort(residues.begin(), residues.end(),
                     [](const Residue& a, const Residue& b) {
                       return a.resseq < b.resseq ||
                              (a.resseq == b.resseq &&
                               a.file_order < b.file_order);
                     });
    for (auto& res : residues) {
      if (res.icode != ' ') ++insertion_offset;

      if (n >= max_res) return -(n + 1);
      float* pos = positions + n * 14 * 3;
      float* msk = atom_mask + n * 14;
      float* bf = bfactors + n * 14;

      int placed = 0;
      for (int a = 0; a < 14; ++a) {
        const SlotAtom& sa = res.slots[a];
        if (sa.occ >= 0.f) {
          pos[a * 3 + 0] = sa.x;
          pos[a * 3 + 1] = sa.y;
          pos[a * 3 + 2] = sa.z;
          msk[a] = 1.f;
          bf[a] = sa.bfac;
          ++placed;
        } else {
          pos[a * 3 + 0] = pos[a * 3 + 1] = pos[a * 3 + 2] = NAN;
          msk[a] = 0.f;
          bf[a] = 0.f;
        }
      }
      if (placed == 0) continue;

      aaindex[n] = res.restype;
      chain_ids[n] = chain;
      out_resseq.push_back(res.resseq + insertion_offset);
      ++n;
    }
  }

  // per-chain duplicate residue-number bumping
  for (int i = 0; i < n; ++i) {
    int idx = out_resseq[i];
    auto& taken = used[chain_ids[i]];
    while (taken.count(idx)) ++idx;
    taken.insert(idx);
    residue_index[i] = idx;
  }
  return n;
}

// Shrake-Rupley solvent-accessible surface area.
//
// positions: [n_atoms*3]; radii: [n_atoms] vdW radii.
// out_area: [n_atoms] per-atom SASA (A^2).
void ppi_sasa(const float* positions, const float* radii, int n_atoms,
              int n_points, float probe, float* out_area) {
  // golden-spiral unit sphere points
  std::vector<float> sx(n_points), sy(n_points), sz(n_points);
  const float golden = (1.f + std::sqrt(5.f)) / 2.f;
  for (int i = 0; i < n_points; ++i) {
    float theta = 2.f * static_cast<float>(M_PI) * i / golden;
    float cz = 1.f - 2.f * (i + 0.5f) / n_points;
    float r = std::sqrt(std::max(0.f, 1.f - cz * cz));
    sx[i] = r * std::cos(theta);
    sy[i] = r * std::sin(theta);
    sz[i] = cz;
  }

  // spatial hash for neighbor pruning
  float max_r = 0.f;
  for (int i = 0; i < n_atoms; ++i) max_r = std::max(max_r, radii[i]);
  const float cell = 2.f * (max_r + probe);
  auto cell_key = [&](float x, float y, float z) {
    long cx = static_cast<long>(std::floor(x / cell));
    long cy = static_cast<long>(std::floor(y / cell));
    long cz = static_cast<long>(std::floor(z / cell));
    return (cx * 73856093L) ^ (cy * 19349663L) ^ (cz * 83492791L);
  };
  std::unordered_map<long, std::vector<int>> grid;
  for (int i = 0; i < n_atoms; ++i)
    grid[cell_key(positions[i * 3], positions[i * 3 + 1], positions[i * 3 + 2])]
        .push_back(i);

  std::vector<int> nbrs;
  for (int i = 0; i < n_atoms; ++i) {
    const float xi = positions[i * 3], yi = positions[i * 3 + 1],
                zi = positions[i * 3 + 2];
    const float ri = radii[i] + probe;

    nbrs.clear();
    for (int dx = -1; dx <= 1; ++dx)
      for (int dy = -1; dy <= 1; ++dy)
        for (int dz = -1; dz <= 1; ++dz) {
          auto it = grid.find(cell_key(xi + dx * cell, yi + dy * cell,
                                       zi + dz * cell));
          if (it == grid.end()) continue;
          for (int j : it->second) {
            if (j == i) continue;
            float ddx = positions[j * 3] - xi, ddy = positions[j * 3 + 1] - yi,
                  ddz = positions[j * 3 + 2] - zi;
            float rj = radii[j] + probe;
            if (ddx * ddx + ddy * ddy + ddz * ddz < (ri + rj) * (ri + rj))
              nbrs.push_back(j);
          }
        }

    int accessible = 0;
    for (int k = 0; k < n_points; ++k) {
      float px = xi + ri * sx[k], py = yi + ri * sy[k], pz = zi + ri * sz[k];
      bool buried = false;
      for (int j : nbrs) {
        float rj = radii[j] + probe;
        float ddx = px - positions[j * 3], ddy = py - positions[j * 3 + 1],
              ddz = pz - positions[j * 3 + 2];
        if (ddx * ddx + ddy * ddy + ddz * ddz < rj * rj) {
          buried = true;
          break;
        }
      }
      if (!buried) ++accessible;
    }
    out_area[i] = 4.f * static_cast<float>(M_PI) * ri * ri * accessible /
                  static_cast<float>(n_points);
  }
}

}  // extern "C"
