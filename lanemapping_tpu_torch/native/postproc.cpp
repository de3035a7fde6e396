// Native polyline post-processing: greedy vertex-string tracker + NMS.
//
// C++ implementation of the sequential host-side stage
// (`lanemapping_tpu/decode/postprocess.py`, behaviour-parity with the
// reference `baseline/utils/polyline_utils.py:57-387`).
// The tracker is inherently serial over rows with data-dependent control
// flow — the one part of the pipeline XLA cannot express efficiently — so it
// runs as native code on the host, overlapped with TPU compute by the
// loader/engine. Exposed through a plain C ABI for ctypes.
//
// Conventions match the Python module: lanes are double[S] column vectors at
// image scale, -1 == no vertex, row anchor r sits at image row 8*r+3.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr double kBuffWidth = 6.0;
constexpr int kBuffDepth = 24;
constexpr double kNmsDist = 10.0;

inline double at(const double* a, int cols, int r, int c) {
  return a[r * cols + c];
}

void sort_left_to_right(std::vector<double>& lines, int n_line, int n_v) {
  std::vector<std::pair<double, int>> keys(n_line);
  for (int i = 0; i < n_line; ++i) {
    double first = 1152.0;
    for (int r = 0; r < n_v; ++r) {
      if (lines[i * n_v + r] >= 0) { first = lines[i * n_v + r]; break; }
    }
    keys[i] = {first, i};
  }
  std::stable_sort(keys.begin(), keys.end());
  std::vector<double> out(lines.size());
  for (int i = 0; i < n_line; ++i)
    std::memcpy(&out[i * n_v], &lines[keys[i].second * n_v],
                n_v * sizeof(double));
  lines.swap(out);
}

void fill_gaps(double* lines, int n_line, int n_v) {
  for (int i = 0; i < n_line; ++i) {
    double* row = lines + i * n_v;
    int prev = -1, first = -1, last = -1;
    for (int r = 0; r < n_v; ++r)
      if (row[r] > 1e-4) { if (first < 0) first = r; last = r; }
    if (first < 0 || last - first < 1) continue;
    prev = first;
    for (int r = first + 1; r <= last; ++r) {
      if (row[r] > 1e-4) {
        if (r - prev > 1) {
          for (int k = prev + 1; k < r; ++k) {
            double t = double(k - prev) / double(r - prev);
            row[k] = (1.0 - t) * row[prev] + t * row[r];
          }
        }
        prev = r;
      }
    }
  }
}

}  // namespace

extern "C" {

// Occupancy thinning: keep the max-confidence vertex per 2*half_k window.
// first_row_only transcribes the reference's occupancy_filter exactly
// (polyline_utils.py:200-220): its early return makes it filter row 0 only,
// with a window sliding over every column.
void lm_thin_vertex_grid(double* occ, const double* conf, int rows, int cols,
                         int half_k, int first_row_only) {
  if (first_row_only) {
    double* row = occ;
    const double* crow = conf;
    for (int c = half_k; c < cols - half_k; ++c) {
      int lo = c - half_k, hi = c + half_k;
      double cnt = 0;
      for (int k = lo; k < hi; ++k) cnt += row[k] > 0 ? row[k] : 0.0;
      if (cnt <= 1) continue;
      int best = -1;
      double best_v = -1e30;
      for (int k = lo; k < hi; ++k)
        if (row[k] > 0 && crow[k] > best_v) { best_v = crow[k]; best = k; }
      for (int k = lo; k < hi; ++k) row[k] = 0;
      row[best] = 1;
    }
    return;
  }
  // Windows are centered ONLY on the row's occupied columns, snapshotted
  // before any thinning (decode/postprocess.py thin_vertex_grid: the numpy
  // `cols = nonzero(out[r])` is taken once per row).  Sliding a window over
  // every column instead also thins vertex pairs 5..7 px apart that no
  // occupied-centered window contains — a divergence the near-parallel
  // merge geometry exposes (tests/test_native.py adversarial cases).
  std::vector<int> cols0;
  for (int r = 0; r < rows; ++r) {
    double* row = occ + r * cols;
    const double* crow = conf + r * cols;
    cols0.clear();
    for (int k = 0; k < cols; ++k)
      if (row[k] > 0) cols0.push_back(k);
    if (cols0.size() < 2) continue;
    for (int c : cols0) {
      int lo = c - half_k, hi = c + half_k;
      if (lo < half_k - 1 || hi > cols - half_k) continue;
      int cnt = 0;
      for (int k = lo; k < hi; ++k) cnt += row[k] > 0;
      if (cnt <= 1) continue;
      int best = -1;
      double best_v = -1e30;
      for (int k = lo; k < hi; ++k)
        if (row[k] > 0 && crow[k] > best_v) { best_v = crow[k]; best = k; }
      for (int k = lo; k < hi; ++k) row[k] = 0;
      row[best] = 1;
    }
  }
}

// Greedy vertex-string tracker (parity with decode/postprocess.smooth_lanes).
// out_cls: [n_line, n_v] raw columns; orient: [n_v, n_v] classes;
// conf_rows: [n_v, img] lane confidence at the row anchors (rows 8r+3 of
// the full map — the only rows any consumer reads, so the device ships
// just these) or nullptr; result: [n_line, n_v].
void lm_smooth_lanes(const double* out_cls, const int32_t* orient,
                     const float* conf_rows_f, int n_line, int n_v, int img,
                     int complete_inner, int occ_first_row, double* result) {
  std::vector<double> src(out_cls, out_cls + n_line * n_v);
  sort_left_to_right(src, n_line, n_v);

  std::vector<double> occ((size_t)n_v * img, 0.0);
  for (int i = 0; i < n_line; ++i)
    for (int r = 0; r < n_v; ++r) {
      double c = out_cls[i * n_v + r];
      if (c > 0) occ[r * img + (int)c] = 1.0;
    }
  if (conf_rows_f) {
    std::vector<double> conf_rows((size_t)n_v * img);
    for (size_t k = 0; k < conf_rows.size(); ++k) conf_rows[k] = conf_rows_f[k];
    lm_thin_vertex_grid(occ.data(), conf_rows.data(), n_v, img, 4,
                        occ_first_row);
  }

  std::vector<double> total((size_t)n_line * n_v, -1.0);
  std::vector<double> total_len(n_line, 0.0);

  auto occ_sum = [&]() {
    double s = 0;
    for (double v : occ) s += v;
    return s;
  };
  auto min_len = [&]() {
    double m = 1e30;
    for (double v : total_len) m = std::min(m, v);
    return m;
  };

  while (occ_sum() > 2 && min_len() < 2) {
    std::vector<double> cand((size_t)n_line * n_v, -1.0);
    std::vector<double> cand_len(n_line, 0.0);
    for (int li = 0; li < n_line; ++li) {
      bool started = false;
      int r = 0, last_r = 0, h_step = 1, active = li;
      double last_c = 0, cur_c = 0;
      while (r < n_v) {
        if (started && (r - last_r > kBuffDepth)) break;
        if (!started) {
          double c = src[li * n_v + r];
          if (c > 0 && occ[r * img + (int)c] > 0) {
            started = true;
            occ[r * img + (int)c] = 0;
            cand[li * n_v + r] = c;
            cand_len[li] += 1;
            last_r = r; last_c = c; cur_c = c; active = li;
          }
          ++r; h_step = 1;
          continue;
        }
        double pred = cur_c;
        if (cand_len[li] > 1) pred = cur_c + (cur_c - last_c) / h_step;
        double near_d = 1152.0;
        int near_i = n_line, near_r = r;
        for (int si = 0; si < n_line; ++si) {
          double c = src[si * n_v + r];
          if (c > 0 && occ[r * img + (int)c] > 0) {
            double d = std::fabs(pred - c);
            if (d < near_d) { near_d = d; near_i = si; near_r = r; }
          }
        }
        for (int rr = r + 1; rr < n_v; ++rr) {
          if (rr - r > kBuffDepth) break;
          double c = src[active * n_v + rr];
          if (c > 0 && occ[rr * img + (int)c] > 0) {
            double d = std::fabs(pred - c);
            if (d < near_d) { near_d = d; near_i = active; near_r = rr; }
            break;
          }
        }
        if (near_d < kBuffWidth) {
          double c = src[near_i * n_v + near_r];
          cand[li * n_v + near_r] = c;
          cand_len[li] += 1;
          occ[near_r * img + (int)c] = 0;
          last_c = cur_c; cur_c = c;
          h_step = near_r - last_r;
          last_r = near_r;
          r = near_r + 1;
          active = near_i;
        } else {
          cand[li * n_v + r] = -1;
          ++r; ++h_step;
        }
      }
    }

    for (int li = 0; li < n_line; ++li) {
      if (cand_len[li] <= 2) continue;
      std::vector<int> v_idx;
      for (int r = 0; r < n_v; ++r)
        if (cand[li * n_v + r] > 0) v_idx.push_back(r);
      int cs = v_idx.front(), ce = v_idx.back();
      double cs_v = cand[li * n_v + cs], ce_v = cand[li * n_v + ce];
      double ce_next = ce_v + (ce_v - cand[li * n_v + v_idx[v_idx.size() - 2]]);
      bool attached = false;
      for (int si = 0; si < n_line && !attached; ++si) {
        if (total_len[si] < 2) continue;
        std::vector<int> t_idx;
        for (int r = 0; r < n_v; ++r)
          if (total[si * n_v + r] > 0) t_idx.push_back(r);
        if (t_idx.size() < 2) continue;
        int ts = t_idx.front(), te = t_idx.back();
        double ts_v = total[si * n_v + ts], te_v = total[si * n_v + te];
        double te_next =
            te_v + (te_v - total[si * n_v + t_idx[t_idx.size() - 2]]);
        bool bottom = (cs - te > 0) && (cs - te < kBuffDepth) &&
                      std::fabs(te_next - cs_v) < kBuffWidth;
        bool top = (ts - ce > 0) && (ts - ce < kBuffDepth) &&
                   std::fabs(ce_next - ts_v) < kBuffWidth;
        if (bottom || top) {
          for (int r : v_idx) total[si * n_v + r] = cand[li * n_v + r];
          total_len[si] += cand_len[li];
          attached = true;
        }
      }
      if (!attached) {
        for (int si = 0; si < n_line; ++si)
          if (total_len[si] < 2) {
            for (int r : v_idx) total[si * n_v + r] = cand[li * n_v + r];
            total_len[si] = cand_len[li];
            break;
          }
      }
    }
  }

  if (complete_inner) fill_gaps(total.data(), n_line, n_v);
  sort_left_to_right(total, n_line, n_v);
  std::memcpy(result, total.data(), total.size() * sizeof(double));
}

// Polyline NMS (parity with decode/postprocess.polyline_nms).
// sem_rows: [n_v, img] confidence at the row anchors.
void lm_polyline_nms(double* lines, const float* sem_rows, int n_line,
                     int n_v, int img) {
  auto count_pos = [&](int i) {
    int n = 0;
    for (int r = 0; r < n_v; ++r) n += lines[i * n_v + r] > 0;
    return n;
  };
  auto overlap = [&](int i, int j, double* mn, double* mx, double* mean) {
    *mn = 1e30; *mx = -1.0; *mean = -1.0;
    double s = 0; int n = 0;
    for (int r = 0; r < n_v; ++r) {
      double a = lines[i * n_v + r], b = lines[j * n_v + r];
      double d = (a < 0 || b < 0) ? -1.0 : std::fabs(a - b);
      *mx = std::max(*mx, d);
      if (d >= 0) { s += d; ++n; *mn = std::min(*mn, d); }
    }
    if (n) *mean = s / n; else *mn = -1.0;
  };

  for (int i = 0; i < n_line - 1; ++i) {
    if (count_pos(i) < 2) continue;
    for (int j = i + 1; j < n_line; ++j) {
      if (count_pos(j) < 2) continue;
      double mn, mx, mean;
      overlap(i, j, &mn, &mx, &mean);
      if (!(mn >= 0 && mn < kNmsDist)) continue;
      double* a = lines + i * n_v;
      double* b = lines + j * n_v;
      // align pass
      for (int r = 0; r < n_v; ++r) {
        if (a[r] < 0 || b[r] < 0) continue;
        if (std::fabs(a[r] - b[r]) < 1e-5) continue;
        if (b[r] < a[r]) std::swap(a[r], b[r]);
        if (std::fabs(a[r] - b[r]) < 2.0 && r > 0) {
          if (std::fabs(a[r] - a[r - 1]) < std::fabs(b[r] - b[r - 1]) &&
              a[r - 1] > 0 && b[r - 1] > 0)
            b[r] = -1;
          else
            a[r] = -1;
        }
      }
      // point-to-point merge pass
      bool has_last_a = false, has_last_b = false;
      double last_a = 0, last_b = 0;
      for (int r = 0; r < n_v; ++r) {
        double va = a[r], vb = b[r];
        if (vb < 0) continue;
        if (va < 0) {
          if (!has_last_a || std::fabs(last_a - vb) < kNmsDist) {
            a[r] = vb; b[r] = -1; last_a = a[r]; has_last_a = true;
          } else { last_b = vb; has_last_b = true; }
        } else {
          if (std::fabs(vb - va) < kNmsDist) {
            double ra = sem_rows[(size_t)r * img + (int)va];
            double rb = sem_rows[(size_t)r * img + (int)vb];
            double high = ra > rb ? va : vb;
            if (!has_last_a && !has_last_b) {
              a[r] = high; b[r] = -1; last_a = a[r]; has_last_a = true;
            } else if (has_last_a && std::fabs(last_a - high) < kNmsDist) {
              a[r] = high; b[r] = -1; last_a = a[r];
            } else {
              a[r] = -1; b[r] = high; last_b = b[r]; has_last_b = true;
            }
          } else if (!has_last_a && !has_last_b) {
            if (va > vb) std::swap(a[r], b[r]);
            last_a = a[r]; last_b = b[r];
            has_last_a = has_last_b = true;
          }
        }
      }
    }
  }
  fill_gaps(lines, n_line, n_v);

  for (int i = 0; i < n_line - 1; ++i) {
    int n_i = count_pos(i);
    if (n_i < 2) {
      for (int r = 0; r < n_v; ++r) lines[i * n_v + r] = -1.0;
      continue;
    }
    for (int j = i + 1; j < n_line; ++j) {
      int n_j = count_pos(j);
      if (n_j < 2) {
        for (int r = 0; r < n_v; ++r) lines[j * n_v + r] = -1.0;
        continue;
      }
      double mn, mx, mean;
      overlap(i, j, &mn, &mx, &mean);
      if (mx >= 0 && (mx < kNmsDist * 1.5 || mean < kNmsDist * 0.8)) {
        int victim = (n_i < n_j) ? i : j;
        for (int r = 0; r < n_v; ++r) lines[victim * n_v + r] = -1.0;
        if (victim == i) break;
      }
    }
  }
}

// Run-length semantic uniformisation + endpoint pruning (parity with
// decode/postprocess.uniform_semantics, reference
// `polyline_utils.py:448-586`).
// cols/sem: [n_line, n_v] in/out; ep: [n_ep, 2] (row, col) endpoint
// candidates; ep_keep: [n_ep] out (1 = keep).
// keep_line_ends: the reference's "no interior endpoints on a
// single-semantic line" prune radius-kills over ALL vertices, which also
// deletes the line's own terminal endpoints exactly when the heatmap and
// the polyline agree; 1 = exempt endpoints within the prune radius of the
// line's first/last vertex (intent-faithful mode, cfg
// `endp_keep_line_ends`).  0 reproduces the reference.
void lm_uniform_semantics(const double* cols, double* sem, int n_line,
                          int n_v, int r_buff, const double* ep, int n_ep,
                          uint8_t* ep_keep, int keep_line_ends) {
  for (int e = 0; e < n_ep; ++e) ep_keep[e] = 1;
  std::vector<double> all_r, all_c;  // vertices of every >=2-vertex lane
  for (int li = 0; li < n_line; ++li) {
    const double* col = cols + (size_t)li * n_v;
    double* srow = sem + (size_t)li * n_v;
    std::vector<int> v_idx;
    for (int r = 0; r < n_v; ++r)
      if (col[r] > 0) v_idx.push_back(r);
    if (v_idx.size() < 2) continue;
    for (int r : v_idx) {
      all_r.push_back(r * 8 + 3);
      all_c.push_back(col[r]);
    }

    // run-length encode the FULL semantic row (zeros included)
    std::vector<std::pair<int, int>> runs;  // (value, count)
    runs.emplace_back((int)srow[0], 1);
    for (int r = 1; r < n_v; ++r) {
      if ((int)srow[r] == runs.back().first) ++runs.back().second;
      else runs.emplace_back((int)srow[r], 1);
    }
    // swallow short runs sandwiched between equal longer neighbours,
    // growing the tolerated void 5 -> r_buff in steps of 3
    for (int void_sz = 5; void_sz < r_buff; void_sz += 3) {
      size_t k = 1;
      while (k + 1 < runs.size()) {
        auto& prev = runs[k - 1];
        auto& cur = runs[k];
        auto& nxt = runs[k + 1];
        if (prev.first > 0 && prev.first != cur.first &&
            nxt.first == prev.first && cur.second < void_sz &&
            prev.second >= cur.second && nxt.second >= cur.second) {
          prev.second += cur.second + nxt.second;
          runs.erase(runs.begin() + k, runs.begin() + k + 2);
          k = 1;
        } else {
          ++k;
        }
      }
    }
    int pos = 0;
    for (auto& rv : runs) {
      for (int r = pos; r < pos + rv.second && r < n_v; ++r)
        srow[r] = rv.first;
      pos += rv.second;
    }

    // a single-semantic long line should carry no interior endpoints
    int best = 0;
    for (auto& rv : runs)
      if (rv.first > 0) best = std::max(best, rv.second);
    if (best > 130 && n_ep) {
      int r_first = v_idx.front(), r_last = v_idx.back();
      for (int e = 0; e < n_ep; ++e) {
        if (!ep_keep[e]) continue;
        if (keep_line_ends) {
          double dr0 = ep[e * 2] - (r_first * 8 + 3);
          double dc0 = ep[e * 2 + 1] - col[r_first];
          double dr1 = ep[e * 2] - (r_last * 8 + 3);
          double dc1 = ep[e * 2 + 1] - col[r_last];
          if (dr0 * dr0 + dc0 * dc0 <= 64.0 ||
              dr1 * dr1 + dc1 * dc1 <= 64.0)
            continue;  // terminal zone: a real line end, keep it
        }
        double dmin = 1e30;
        for (int r : v_idx) {
          double dr = ep[e * 2] - (r * 8 + 3);
          double dc = ep[e * 2 + 1] - col[r];
          dmin = std::min(dmin, dr * dr + dc * dc);
        }
        if (dmin <= 64.0) ep_keep[e] = 0;  // d <= 8
      }
    }
  }

  // prune endpoints with no polyline vertex within 10 px
  if (n_ep && !all_r.empty()) {
    for (int e = 0; e < n_ep; ++e) {
      if (!ep_keep[e]) continue;
      double dmin = 1e30;
      for (size_t k = 0; k < all_r.size(); ++k) {
        double dr = ep[e * 2] - all_r[k];
        double dc = ep[e * 2 + 1] - all_c[k];
        dmin = std::min(dmin, dr * dr + dc * dc);
      }
      if (dmin > 100.0) ep_keep[e] = 0;  // d > 10
    }
  }
}

}  // extern "C"
