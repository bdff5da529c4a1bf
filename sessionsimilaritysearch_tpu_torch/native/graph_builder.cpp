// Whole-batch session-graph builder.
//
// Host-side counterpart of data/graph.py:sequence_to_graph + batch_graphs
// (semantics from reference util_amazon_filtered.py:98-230): one C call
// builds an entire padded batch — tokenization included — writing directly
// into preallocated numpy arrays. Python's per-session builder is ~1 ms of
// interpreter work; at corpus-embedding scale that, not the TPU, bounds
// throughput (docs/RESULTS.md), so the whole transform moves here and
// parallelizes over sessions with OpenMP.
//
// Equivalence with the Python builder is enforced bit-exactly by
// tests/test_native.py::test_graph_builder_matches_python.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

#include "tokenize_inl.h"

namespace {

struct Txt {
  const char* p;
  size_t n;
};

// Action streams, flattened over the batch (see native/__init__.py
// marshalling). type codes: 0 = 's', 1 = 'c' (and unknown click kinds,
// which CLICK_TYPE_IDS.get(t, 0) also maps to 0), 2 = 'ca', 3 = 'p'.
struct Stream {
  const int32_t* off;       // [B+1] per-session action offsets
  const uint8_t* type;      // [NA]
  const int32_t* asin;      // [NA]
  const int64_t* txt_off;   // [NA+1] offsets into blob
  const uint8_t* txt_null;  // [NA] 1 = text was None
  const char* blob;

  Txt text(int64_t i) const {
    // None -> "" for node features (graph.py:139, schema.py:90,117)
    if (txt_null[i]) return {"", 0};
    return {blob + txt_off[i], (size_t)(txt_off[i + 1] - txt_off[i])};
  }
};

struct Dims {
  int32_t T, Q, P, O, TgP, TgQ, TXT, max_seq_len;
};

// SessionGraph field order (data/graph.py:32-88); outs[i] aliases field i.
enum Field {
  F_Q_IDS = 0, F_Q_TYP, F_Q_ATT, F_Q_POS, F_Q_NODE_MASK, F_Q_LOSS_MASK,
  F_P_ASIN, F_P_IDS, F_P_TYP, F_P_ATT, F_P_CNT, F_P_NODE_MASK, F_LAST_CLICK,
  F_OCC_PRODUCT, F_OCC_POS, F_OCC_MASK,
  F_ADJ_QP, F_ADJ_PP,
  F_PT_Y, F_PT_MASK, F_PT_CLICK_TYPE, F_PT_IDS, F_PT_TYP, F_PT_ATT,
  F_QT_IDS, F_QT_TYP, F_QT_ATT, F_QT_MASK, F_QT_NODE_MASK,
  F_TX_IDS, F_TX_TYP, F_TX_ATT, F_TX_NODE_MASK,
  F_IDX, F_N_ACTIONS,
  F_COUNT,
};

inline int32_t* i32(void** outs, int f) { return (int32_t*)outs[f]; }
inline float* f32(void** outs, int f) { return (float*)outs[f]; }

void build_one(const Stream& seq_s, const Stream& tar_s, int32_t b,
               const int32_t* idx_in, const Dims& d, int32_t vocab,
               int32_t ignore_query, void** outs) {
  const int32_t T = d.T, Q = d.Q, P = d.P, O = d.O;
  const int32_t TgP = d.TgP, TgQ = d.TgQ, TXT = d.TXT;
  const size_t sb = (size_t)b;

  // ---- select prefix actions: drop searches under ignore_query, then
  // truncate to max_seq_len (graph.py:129-131)
  std::vector<int64_t> sa;
  for (int64_t i = seq_s.off[b]; i < seq_s.off[b + 1]; ++i) {
    if (ignore_query && seq_s.type[i] == 0) continue;
    if ((int32_t)sa.size() >= d.max_seq_len) break;
    sa.push_back(i);
  }
  const int32_t n = (int32_t)sa.size();
  auto clip_pos = [&](int32_t v) {
    return std::min(std::max(v, 0), d.max_seq_len);
  };

  // ---- query nodes: root '' + one per search action (graph.py:134-156)
  std::vector<Txt> qtexts{{"", 0}};
  std::vector<int32_t> qpos_raw{0};
  for (int32_t i = 0; i < n && (int32_t)qtexts.size() < Q; ++i) {
    if (seq_s.type[sa[i]] != 0) continue;
    qtexts.push_back(seq_s.text(sa[i]));
    qpos_raw.push_back(i + 1);
  }
  const int32_t nq = (int32_t)qtexts.size();
  for (int32_t qi = 0; qi < nq; ++qi) {
    size_t row = (sb * Q + qi) * T;
    sss::tokenize_row_mask(qtexts[qi].p, qtexts[qi].n, T, vocab,
                           i32(outs, F_Q_IDS) + row, i32(outs, F_Q_ATT) + row);
    i32(outs, F_Q_POS)[sb * Q + qi] = clip_pos(n - qpos_raw[qi]);
    f32(outs, F_Q_NODE_MASK)[sb * Q + qi] = 1.0f;
    f32(outs, F_Q_LOSS_MASK)[sb * Q + qi] = qi == 0 ? 0.0f : 1.0f;
  }

  // ---- distinct products, counts, per-occurrence reverse positions
  // (graph.py:158-166, schema.get_item_pos_cnt). Counts/positions are
  // computed over ALL distinct items, then truncated — matching Python's
  // order of operations.
  std::vector<int32_t> distinct;
  for (int32_t i = 0; i < n; ++i) {
    if (seq_s.type[sa[i]] == 0) continue;
    int32_t a = seq_s.asin[sa[i]];
    if (std::find(distinct.begin(), distinct.end(), a) == distinct.end())
      distinct.push_back(a);
  }
  std::vector<int32_t> cnt(distinct.size(), 0), pos_list;
  for (size_t it = 0; it < distinct.size(); ++it)
    for (int32_t j = 0; j < n; ++j)
      if (seq_s.type[sa[j]] != 0 && seq_s.asin[sa[j]] == distinct[it]) {
        ++cnt[it];
        pos_list.push_back(n - j);
      }
  bool placeholder = distinct.empty();  // graph.py:161-162 (ref :132-135)
  if (placeholder) {
    distinct = {0};
    cnt = {1};
    pos_list = {0};
  }
  const int32_t np_nodes = (int32_t)std::min((size_t)P, distinct.size());

  // first-seen title per (truncated) distinct item (graph.py:168-171)
  std::vector<Txt> titles;
  for (int32_t it = 0; it < np_nodes; ++it)
    for (int32_t j = 0; j < n; ++j)
      if (seq_s.type[sa[j]] != 0 && seq_s.asin[sa[j]] == distinct[it]) {
        titles.push_back(seq_s.text(sa[j]));
        break;
      }
  if (titles.empty()) titles.push_back({"UNK", 3});
  for (int32_t r = 0; r < (int32_t)titles.size() && r < P; ++r) {
    size_t row = (sb * P + r) * T;
    sss::tokenize_row_mask(titles[r].p, titles[r].n, T, vocab,
                           i32(outs, F_P_IDS) + row, i32(outs, F_P_ATT) + row);
  }
  for (int32_t it = 0; it < np_nodes; ++it) {
    i32(outs, F_P_ASIN)[sb * P + it] = distinct[it];
    i32(outs, F_P_CNT)[sb * P + it] = cnt[it];
    f32(outs, F_P_NODE_MASK)[sb * P + it] = 1.0f;
  }

  // ---- occurrence stream (graph.py:181-193)
  int32_t no = 0;
  for (int32_t it = 0; it < np_nodes && no < O; ++it)
    for (int32_t c = 0; c < cnt[it] && no < O; ++c) {
      i32(outs, F_OCC_PRODUCT)[sb * O + no] = it;
      i32(outs, F_OCC_POS)[sb * O + no] = clip_pos(pos_list[no]);
      f32(outs, F_OCC_MASK)[sb * O + no] = 1.0f;
      ++no;
    }

  // ---- click edges query->product with multiplicity (graph.py:195-202)
  auto pidx = [&](int32_t asin) -> int32_t {
    for (int32_t it = 0; it < np_nodes; ++it)
      if (distinct[it] == asin) return it;
    return -1;
  };
  int32_t last_q = 0;
  for (int32_t i = 0; i < n; ++i) {
    if (seq_s.type[sa[i]] == 0) {
      last_q = std::min(last_q + 1, Q - 1);
      continue;
    }
    int32_t p = pidx(seq_s.asin[sa[i]]);
    if (p >= 0) f32(outs, F_ADJ_QP)[(sb * Q + last_q) * P + p] += 1.0f;
  }

  // ---- product->product transitions + last click (graph.py:204-215)
  std::vector<int32_t> iseq;
  for (int32_t i = 0; i < n; ++i)
    if (seq_s.type[sa[i]] != 0) iseq.push_back(seq_s.asin[sa[i]]);
  if (iseq.empty()) iseq.push_back(0);
  int32_t last_click = 0;
  for (size_t i = 0; i + 1 < iseq.size(); ++i) {
    int32_t a = pidx(iseq[i]), c = pidx(iseq[i + 1]);
    if (a < 0 || c < 0) continue;
    f32(outs, F_ADJ_PP)[(sb * P + a) * P + c] += 1.0f;
    last_click = c;
  }
  f32(outs, F_LAST_CLICK)[sb * P + last_click] = 1.0f;

  // ---- product targets: distinct future items (graph.py:217-234); the
  // future stream is neither query-filtered nor length-truncated
  const int64_t t0 = tar_s.off[b], t1 = tar_s.off[b + 1];
  std::vector<int32_t> tgt;
  for (int64_t i = t0; i < t1 && (int32_t)tgt.size() < TgP; ++i) {
    if (tar_s.type[i] == 0) continue;
    int32_t a = tar_s.asin[i];
    if (std::find(tgt.begin(), tgt.end(), a) == tgt.end()) tgt.push_back(a);
  }
  const int32_t ntp = (int32_t)tgt.size();
  std::vector<Txt> tgt_titles;
  for (int32_t it = 0; it < ntp; ++it) {
    i32(outs, F_PT_Y)[sb * TgP + it] = tgt[it];
    f32(outs, F_PT_MASK)[sb * TgP + it] = 1.0f;
    for (int64_t i = t0; i < t1; ++i)
      if (tar_s.type[i] != 0 && tar_s.asin[i] == tgt[it]) {
        // CLICK_TYPE_IDS {'c':0,'ca':1,'p':2}, .get(t, 0) for unknown kinds
        int32_t ct = tar_s.type[i] == 2 ? 1 : (tar_s.type[i] == 3 ? 2 : 0);
        i32(outs, F_PT_CLICK_TYPE)[sb * TgP + it] = ct;
        tgt_titles.push_back(tar_s.text(i));
        break;
      }
  }
  if (tgt_titles.empty()) tgt_titles.push_back({"UNK", 3});
  for (int32_t r = 0; r < (int32_t)tgt_titles.size() && r < TgP; ++r) {
    size_t row = (sb * TgP + r) * T;
    sss::tokenize_row_mask(tgt_titles[r].p, tgt_titles[r].n, T, vocab,
                           i32(outs, F_PT_IDS) + row,
                           i32(outs, F_PT_ATT) + row);
  }

  // ---- query targets: future non-null keywords, or masked '' placeholder
  // (graph.py:236-251)
  std::vector<Txt> fq;
  for (int64_t i = t0; i < t1 && (int32_t)fq.size() < TgQ; ++i)
    if (tar_s.type[i] == 0 && !tar_s.txt_null[i]) fq.push_back(tar_s.text(i));
  float qt_valid = 1.0f;
  if (fq.empty()) {
    fq.push_back({"", 0});
    qt_valid = 0.0f;
  }
  for (int32_t r = 0; r < (int32_t)fq.size(); ++r) {
    size_t row = (sb * TgQ + r) * T;
    sss::tokenize_row_mask(fq[r].p, fq[r].n, T, vocab,
                           i32(outs, F_QT_IDS) + row,
                           i32(outs, F_QT_ATT) + row);
    f32(outs, F_QT_MASK)[sb * TgQ + r] = qt_valid;
    f32(outs, F_QT_NODE_MASK)[sb * TgQ + r] = 1.0f;
  }

  // ---- whole-session text: root '' + one sentence per action
  // (graph.py:253-259, schema.session_to_text)
  std::vector<Txt> text{{"", 0}};
  for (int32_t i = 0; i < n && (int32_t)text.size() < TXT; ++i)
    text.push_back(seq_s.text(sa[i]));
  for (int32_t r = 0; r < (int32_t)text.size(); ++r) {
    size_t row = (sb * TXT + r) * T;
    sss::tokenize_row_mask(text[r].p, text[r].n, T, vocab,
                           i32(outs, F_TX_IDS) + row,
                           i32(outs, F_TX_ATT) + row);
    f32(outs, F_TX_NODE_MASK)[sb * TXT + r] = 1.0f;
  }

  i32(outs, F_IDX)[b] = idx_in[b];
  i32(outs, F_N_ACTIONS)[b] = n;
}

}  // namespace

extern "C" {

// Build a full padded SessionGraph batch. All output arrays must be
// pre-zeroed (np.zeros); only non-zero entries are written. type_ids
// fields (always zero for the hashing tokenizer) are never touched.
void build_graph_batch(
    // prefix stream
    const int32_t* seq_off, const uint8_t* seq_type, const int32_t* seq_asin,
    const int64_t* seq_txt_off, const uint8_t* seq_txt_null,
    const char* seq_blob,
    // future (target) stream
    const int32_t* tar_off, const uint8_t* tar_type, const int32_t* tar_asin,
    const int64_t* tar_txt_off, const uint8_t* tar_txt_null,
    const char* tar_blob,
    const int32_t* idx_in, int32_t batch,
    const int32_t* dims8,  // T, Q, P, O, TgP, TgQ, TXT, max_seq_len
    int32_t vocab_size, int32_t ignore_query, void** outs) {
  Stream seq_s{seq_off, seq_type, seq_asin, seq_txt_off, seq_txt_null,
               seq_blob};
  Stream tar_s{tar_off, tar_type, tar_asin, tar_txt_off, tar_txt_null,
               tar_blob};
  Dims d{dims8[0], dims8[1], dims8[2], dims8[3],
         dims8[4], dims8[5], dims8[6], dims8[7]};
#pragma omp parallel for schedule(dynamic)
  for (int32_t b = 0; b < batch; ++b)
    build_one(seq_s, tar_s, b, idx_in, d, vocab_size, ignore_query, outs);
}

}  // extern "C"
