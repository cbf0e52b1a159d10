// Token-level FSM table construction — the framework's native replacement for the
// reference's Outlines/numba FSM compilation (src/judge/safety_checker.py:3-5
// depends on outlines>=0.0.40 whose regex->token-table path is numba-compiled;
// SURVEY.md §2.4). Lifts a byte-level DFA to a token-level transition table
// next_state[state, token_id] by walking each vocab piece's bytes from every
// DFA state: O(S · V · len). For a 262k-token gemma vocab this is ~1.5 s in
// pure Python and ~30 ms here.
//
// Build: g++ -O3 -shared -fPIC -o fsm_table.so fsm_table.cpp
// ABI kept C-plain for ctypes.

#include <cstdint>

extern "C" {

// trans:   (S, 256) int32 row-major, -1 = dead
// blob:    concatenated token byte strings
// offsets: (V+1) int64 prefix offsets into blob; offsets[v+1]-offsets[v] = len
//          (len 0 marks tokens with no byte rendering: never allowed -> -1)
// out:     (S, V) int32 row-major, fully written
void build_token_table(const int32_t* trans, int32_t n_states,
                       const uint8_t* blob, const int64_t* offsets,
                       int32_t n_tokens, int32_t* out) {
  for (int32_t s = 0; s < n_states; ++s) {
    int32_t* row = out + static_cast<int64_t>(s) * n_tokens;
    for (int32_t t = 0; t < n_tokens; ++t) {
      const int64_t beg = offsets[t];
      const int64_t len = offsets[t + 1] - beg;
      if (len == 0) {
        row[t] = -1;
        continue;
      }
      int32_t cur = s;
      for (int64_t i = 0; i < len; ++i) {
        cur = trans[static_cast<int64_t>(cur) * 256 + blob[beg + i]];
        if (cur < 0) break;
      }
      row[t] = cur;
    }
  }
}

}  // extern "C"
