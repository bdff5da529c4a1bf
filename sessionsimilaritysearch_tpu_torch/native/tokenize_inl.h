// Shared hashing-tokenizer inner loop (mirrors tokenizer.HashTokenizer
// exactly; see tokenizer.py:41-90). Used by the batch tokenizer entry point
// (levenshtein.cpp) and the whole-graph builder (graph_builder.cpp).
#pragma once

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace sss {

static inline uint64_t fnv1a64(const char* s, size_t n) {
  uint64_t h = 0xCBF29CE484222325ull;
  for (size_t i = 0; i < n; ++i) {
    h ^= (uint8_t)s[i];
    h *= 0x100000001B3ull;
  }
  return h;
}

// Tokenize one text into row[max_len] int32 ids (pad 0, cls 2, sep 3; word
// ids in [5, vocab)). Word split: [a-z0-9]+ over lowercased input. The row
// is fully overwritten. Truncation matches HashTokenizer.encode_one: if the
// id list exceeds max_len, cut to max_len - 1 and append SEP.
static inline void tokenize_row(const char* s, size_t len, int32_t max_len,
                                int32_t vocab_size, int32_t* row) {
  const int32_t CLS = 2, SEP = 3, NUM_SPECIAL = 5;
  std::memset(row, 0, sizeof(int32_t) * max_len);
  std::vector<int32_t> ids;
  ids.push_back(CLS);
  size_t i = 0;
  while (i < len && (int32_t)ids.size() < max_len + 8) {
    while (i < len) {
      char c = s[i];
      if ((c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z') ||
          (c >= '0' && c <= '9'))
        break;
      ++i;
    }
    size_t start = i;
    std::string word;
    while (i < len) {
      char c = s[i];
      if ((c >= 'a' && c <= 'z') || (c >= '0' && c <= '9')) {
        word.push_back(c);
      } else if (c >= 'A' && c <= 'Z') {
        word.push_back(c - 'A' + 'a');
      } else {
        break;
      }
      ++i;
    }
    if (i == start) break;
    ids.push_back(NUM_SPECIAL +
                  (int32_t)(fnv1a64(word.data(), word.size()) %
                            (uint64_t)(vocab_size - NUM_SPECIAL)));
  }
  ids.push_back(SEP);
  if ((int32_t)ids.size() > max_len) {
    ids.resize(max_len - 1);
    ids.push_back(SEP);
  }
  for (size_t j = 0; j < ids.size() && (int32_t)j < max_len; ++j)
    row[j] = ids[j];
}

// ids + attention mask (mask = ids != 0, tokenizer.py:84)
static inline void tokenize_row_mask(const char* s, size_t len,
                                     int32_t max_len, int32_t vocab_size,
                                     int32_t* ids, int32_t* att) {
  tokenize_row(s, len, max_len, vocab_size, ids);
  for (int32_t j = 0; j < max_len; ++j) att[j] = ids[j] != 0 ? 1 : 0;
}

}  // namespace sss
