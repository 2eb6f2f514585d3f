// liboppack — native op-log packing for the TPU replay path.
//
// The host-side hot loop of bulk catch-up is turning op streams into the
// padded (D, T) int32 arrays the merge-tree kernel folds (see
// fluidframework_tpu/ops/mergetree_kernel.py::pack_mergetree_batch).  The
// ingestion side encodes string-channel ops once into a flat binary record
// stream (ops/native_pack.py::encode_string_ops); this library consumes
// that stream and fills the arrays in one pass — no Python objects, no
// per-op dict lookups.
//
// Record layout (little-endian, packed):
//   u8  kind        (1=insert, 2=remove, 3=annotate, 4=obliterate)
//   i32 seq
//   i32 ref_seq
//   i32 min_seq     (stamped MSN — zamboni-expiry parity on device)
//   i32 client_idx  (interned by the encoder)
//   i32 a           (pos | start)
//   i32 b           (end; 0 for insert)
//   i32 n_props     (annotate property pairs)
//   i32 text_len    (insert only, BYTES of utf-8; 0 otherwise)
//   { i32 key_idx, i32 val_idx } * n_props   (val -1 == PROP_ABSENT)
//   u8  text[text_len]
//
// Text offsets in the arrays are in CHARACTERS (the Python arena is a str);
// the packer counts code points while copying utf-8 bytes, so the caller
// can decode the byte arena once and every (tstart, tlen) span aligns.
//
// API (C ABI, ctypes-consumed):
//   oppack_count(...)    — sizing pre-pass
//   oppack_scan(...)     — a range of documents' sizes and value facts
//   oppack_fill(...)     — fill a range of documents' rows, wide or narrow
//   oppack_extract(...)  — final device state → canonical summary-body JSON
//
// oppack_extract consumes the fused export buffer ([D, F, S] int32, see
// mergetree_kernel.EXPORT_SLOT_FIELDS) and emits, per document, the exact
// bytes of canonical_json(normalized_records): sorted keys, minimal
// separators, ensure_ascii=False (UTF-8 passthrough; only '"', '\\' and
// control chars escape, matching python json.dumps).  Slot rows carry two
// obliterate stamp pairs (rows 8..11); in-window stamps (> msn) emit as
// "ob":[[seq,"client"],...] and pin their tombstones past normal expiry.

#include <cstdint>
#include <cstring>
#include <initializer_list>

namespace {
constexpr int64_t kHeader = 1 + 4 * 8;  // kind byte + 8 i32 fields

inline int64_t count_codepoints(const uint8_t* p, int64_t n) {
    int64_t chars = 0;
    for (int64_t i = 0; i < n; ++i) {
        chars += (p[i] & 0xC0) != 0x80;
    }
    return chars;
}

constexpr int32_t kInsert = 1;
constexpr int32_t kObliterate = 4;
constexpr int32_t kPropNotTouched = -2;

// oppack_scan's facts, a row of kScanFacts int64 a document.  Each lo / hi
// starts from 0, as a padded plane's min / max(initial=0) does.
enum ScanFact {
    kOps, kTextBytes, kTextChars,
    kKindLo, kKindHi, kSeqLo, kSeqHi, kClientLo, kClientHi,
    kRefLo, kRefHi, kMsnLo, kMsnHi, kALo, kAHi, kBLo, kBHi,
    kTlenHi,     // the longest text, in chars
    kInsAtHi,    // the furthest char offset of an insert's text in its doc
    kValLo, kValHi,  // property value ids as the stream holds them
    kFlags,
    kScanFacts
};
// kFlags bits
constexpr int64_t kHasObliterate = 1;   // an obliterate record
constexpr int64_t kNotSequential = 2;   // a real op with ref_seq != seq - 1
constexpr int64_t kEmptyInsert = 4;     // an insert with no text
constexpr int64_t kOtherTextPast0 = 8;  // text on another kind, past char 0
constexpr int64_t kOtherTextAt0 = 16;   // text on another kind, at char 0

inline void widen_range(int64_t* f, int lo, int64_t v) {
    if (v < f[lo]) f[lo] = v;
    if (v > f[lo + 1]) f[lo + 1] = v;
}

// One document's rows: a row an op, its text copied to the arena (tstart /
// tlen its span in chars), each property pair in its pvals column (the
// rest PROP_NOT_TOUCHED), key and value ids through the maps (null: the
// stream's ids; a negative value id, PROP_ABSENT, passes untranslated);
// then the padding of the rows past its last op.  B is the element type
// of kind and client, W of the other planes: int32 both for the wide
// pack; int8 and int16 for the narrow upload encoding, where an insert's
// tstart is rebased to its document and any other row's is 0.  Returns
// the ops, or -1 on malformed input or more than T ops.
template <typename B, typename W>
int32_t fill_doc(const uint8_t* buf, int64_t len, int32_t T, int32_t K,
                 int64_t doc_base, bool narrow, B* kind, W* seq, B* client,
                 W* ref_seq, W* min_seq, W* a, W* b, W* tstart, W* tlen,
                 W* pvals, const int32_t* key_map, int32_t n_keys,
                 const int32_t* val_map, int32_t n_vals, uint8_t* arena_out,
                 int64_t arena_capacity, int64_t* arena_used) {
    for (int64_t i = 0; i < static_cast<int64_t>(T) * K; ++i)
        pvals[i] = static_cast<W>(kPropNotTouched);
    int64_t off = 0;
    int32_t t = 0;
    int64_t out_chars = 0;
    int64_t used = *arena_used;
    while (off < len) {
        if (off + kHeader > len) return -1;
        if (t >= T) return -1;
        const uint8_t k = buf[off];
        int32_t fields[8];
        std::memcpy(fields, buf + off + 1, 4 * 8);
        off += kHeader;
        const int32_t n_props = fields[6];
        const int32_t text_len = fields[7];
        if (n_props < 0 || text_len < 0) return -1;
        if (off + 8 * static_cast<int64_t>(n_props) + text_len > len)
            return -1;
        kind[t] = static_cast<B>(k);
        seq[t] = static_cast<W>(fields[0]);
        ref_seq[t] = static_cast<W>(fields[1]);
        min_seq[t] = static_cast<W>(fields[2]);
        client[t] = static_cast<B>(fields[3]);
        a[t] = static_cast<W>(fields[4]);
        b[t] = static_cast<W>(fields[5]);
        for (int32_t i = 0; i < n_props; ++i) {
            int32_t pair[2];
            std::memcpy(pair, buf + off, 8);
            off += 8;
            int32_t col = pair[0];
            int32_t val = pair[1];
            if (key_map != nullptr) {
                if (col < 0 || col >= n_keys) return -1;
                col = key_map[col];
            }
            if (val_map != nullptr && val >= 0) {
                if (val >= n_vals) return -1;
                val = val_map[val];
            }
            if (col < 0 || col >= K) return -1;
            pvals[static_cast<int64_t>(t) * K + col] = static_cast<W>(val);
        }
        const bool insert = k == kInsert;
        if (text_len > 0) {
            if (used + text_len > arena_capacity) return -1;
            std::memcpy(arena_out + used, buf + off, text_len);
            const int64_t chars = count_codepoints(buf + off, text_len);
            if (narrow) {
                tstart[t] = static_cast<W>(insert ? out_chars : 0);
            } else {
                tstart[t] = static_cast<W>(
                    static_cast<int32_t>(doc_base + out_chars));
            }
            tlen[t] = static_cast<W>(chars);
            used += text_len;
            out_chars += chars;
            off += text_len;
        } else {
            tstart[t] = static_cast<W>(narrow && insert ? -doc_base : 0);
            tlen[t] = 0;
        }
        t += 1;
    }
    const int64_t pad = T - t;
    std::memset(kind + t, 0, pad * sizeof(B));
    std::memset(client + t, 0, pad * sizeof(B));
    for (W* row : {seq, ref_seq, min_seq, a, b, tstart, tlen})
        std::memset(row + t, 0, pad * sizeof(W));
    *arena_used = used;
    return t;
}
}  // namespace

extern "C" {

// Sizing pre-pass.  Returns 0 on success; -1 on truncated/malformed input.
int oppack_count(const uint8_t* buf, int64_t len,
                 int32_t* n_ops, int64_t* text_bytes, int64_t* text_chars) {
    int64_t off = 0;
    int32_t ops = 0;
    int64_t bytes = 0, chars = 0;
    while (off < len) {
        if (off + kHeader > len) return -1;
        int32_t fields[8];
        std::memcpy(fields, buf + off + 1, 4 * 8);
        const int32_t n_props = fields[6];
        const int32_t text_len = fields[7];
        off += kHeader;
        if (n_props < 0 || text_len < 0) return -1;
        if (off + 8 * static_cast<int64_t>(n_props) + text_len > len)
            return -1;
        off += 8 * static_cast<int64_t>(n_props);
        chars += count_codepoints(buf + off, text_len);
        bytes += text_len;
        off += text_len;
        ops += 1;
    }
    *n_ops = ops;
    *text_bytes = bytes;
    *text_chars = chars;
    return 0;
}

// Sizes and value facts of documents [0, D) of a range, one row of
// kScanFacts int64 a document in `facts` (see ScanFact): what the pack's
// buckets and its chunk-wide facts need, and the bounds that decide
// whether the range's rows fit the narrow upload encoding, without filling
// a plane.  Returns 0, or -1 - d for the first malformed document.
int32_t oppack_scan(int32_t D, const uint8_t* const* blobs,
                    const int64_t* lens, int64_t* facts) {
    for (int32_t d = 0; d < D; ++d) {
        const uint8_t* buf = blobs[d];
        const int64_t len = lens[d];
        int64_t* f = facts + static_cast<int64_t>(d) * kScanFacts;
        for (int i = 0; i < kScanFacts; ++i) f[i] = 0;
        int64_t off = 0;
        while (off < len) {
            if (off + kHeader > len) return -1 - d;
            const int32_t k = buf[off];
            int32_t fields[8];
            std::memcpy(fields, buf + off + 1, 4 * 8);
            off += kHeader;
            const int32_t n_props = fields[6];
            const int32_t text_len = fields[7];
            if (n_props < 0 || text_len < 0) return -1 - d;
            if (off + 8 * static_cast<int64_t>(n_props) + text_len > len)
                return -1 - d;
            widen_range(f, kKindLo, k);
            widen_range(f, kSeqLo, fields[0]);
            widen_range(f, kRefLo, fields[1]);
            widen_range(f, kMsnLo, fields[2]);
            widen_range(f, kClientLo, fields[3]);
            widen_range(f, kALo, fields[4]);
            widen_range(f, kBLo, fields[5]);
            if (k == kObliterate) f[kFlags] |= kHasObliterate;
            // ref_seq != seq - 1 in int32, as the plane's test wraps
            if (k != 0 && fields[1] != static_cast<int32_t>(
                    static_cast<uint32_t>(fields[0]) - 1u))
                f[kFlags] |= kNotSequential;
            for (int32_t i = 0; i < n_props; ++i) {
                int32_t pair[2];
                std::memcpy(pair, buf + off, 8);
                off += 8;
                widen_range(f, kValLo, pair[1]);
            }
            if (text_len > 0) {
                const int64_t at = f[kTextChars];
                const int64_t chars = count_codepoints(buf + off, text_len);
                if (k == kInsert) {
                    if (at > f[kInsAtHi]) f[kInsAtHi] = at;
                } else {
                    f[kFlags] |= at > 0 ? kOtherTextPast0 : kOtherTextAt0;
                }
                if (chars > f[kTlenHi]) f[kTlenHi] = chars;
                f[kTextBytes] += text_len;
                f[kTextChars] += chars;
                off += text_len;
            } else if (k == kInsert) {
                f[kFlags] |= kEmptyInsert;
            }
            f[kOps] += 1;
        }
    }
    return 0;
}

// Fills the op rows of documents [0, D) of a range from their streams
// (fill_doc), padding each document's rows past its last op (0;
// PROP_NOT_TOUCHED in pvals).  `planes`: the range's first row of each of
// the ten op planes (kind, seq, client, ref_seq, min_seq, a, b, tstart,
// tlen, pvals).  narrow = 0: int32 planes, tstart
// the arena offset doc_base[d] + chars before; narrow = 1: the narrow
// upload encoding (mergetree_kernel.narrow_ops_for_upload): kind and client
// int8, the rest int16, an insert's tstart less doc_base[d], any other
// row's 0 — the caller has checked every value fits (oppack_scan).
// key_offs / val_offs (D + 1 each) delimit each document's maps in
// key_map / val_map; an empty map passes the stream's ids through.  The documents' text goes to arena_out in
// order.  Returns 0, or -1 - d for the first document that is malformed or
// holds more than T ops.
int32_t oppack_fill(int32_t D, const uint8_t* const* blobs,
                    const int64_t* lens, int32_t T, int32_t K,
                    int32_t narrow, const int32_t* doc_base,
                    void* const* planes,
                    const int32_t* key_map, const int64_t* key_offs,
                    const int32_t* val_map, const int64_t* val_offs,
                    uint8_t* arena_out, int64_t arena_capacity) {
    int64_t used = 0;
    for (int32_t d = 0; d < D; ++d) {
        const int64_t row = static_cast<int64_t>(d) * T;
        const int32_t n_keys =
            static_cast<int32_t>(key_offs[d + 1] - key_offs[d]);
        const int32_t n_vals =
            static_cast<int32_t>(val_offs[d + 1] - val_offs[d]);
        const int32_t* km = n_keys > 0 ? key_map + key_offs[d] : nullptr;
        const int32_t* vm = n_vals > 0 ? val_map + val_offs[d] : nullptr;
        int32_t rc;
        if (narrow) {
            auto p8 = [&](int i) {
                return static_cast<int8_t*>(planes[i]) + row;
            };
            auto p16 = [&](int i) {
                return static_cast<int16_t*>(planes[i]) + row;
            };
            rc = fill_doc<int8_t, int16_t>(
                blobs[d], lens[d], T, K, doc_base[d], true, p8(0), p16(1),
                p8(2), p16(3), p16(4), p16(5), p16(6), p16(7), p16(8),
                static_cast<int16_t*>(planes[9]) + row * K, km, n_keys, vm,
                n_vals, arena_out, arena_capacity, &used);
        } else {
            auto p32 = [&](int i) {
                return static_cast<int32_t*>(planes[i]) + row;
            };
            rc = fill_doc<int32_t, int32_t>(
                blobs[d], lens[d], T, K, doc_base[d], false, p32(0), p32(1),
                p32(2), p32(3), p32(4), p32(5), p32(6), p32(7), p32(8),
                static_cast<int32_t*>(planes[9]) + row * K, km, n_keys, vm,
                n_vals, arena_out, arena_capacity, &used);
        }
        if (rc < 0) return -1 - d;
    }
    return 0;
}

// Final device state → canonical summary-body JSON for every document of a
// chunk, in one pass.  Layout contract with mergetree_kernel._export_state:
//   export_buf: [D, F, S] int32, C order, F = 12 + K + 1
//     rows 0..7: tstart, tlen, ins_seq, ins_client,
//                rem_seq, rem_client, rem2_seq, rem2_client
//     rows 8..11: ob1_seq, ob1_client, ob2_seq, ob2_client
//     rows 12..12+K-1: property value ids (PROP_ABSENT = -1)
//     row  12+K (misc): [n, overflow, live_len, 0...]
//   arena_utf8: the chunk text arena; tstart/tlen are CHAR offsets, so a
//     char→byte index is built once here.
//   client_json / key_json / val_json: pre-serialized JSON tokens
//     (canonical_json of each client name / property key / value),
//     flattened with offset tables.  clients are per-doc
//     (client_doc_start[d] .. client_doc_start[d+1] index the offs table);
//     keys arrive in SORTED key order with key_cols[k] = the export row of
//     the k-th sorted key.
//   msn / final over per doc: msn drives tombstone expiry + seq clamping.
// Output: out (capacity out_cap) receives the concatenated bodies;
//   out_offs[d]..out_offs[d+1] delimit doc d.  Docs flagged by `skip` get
//   empty bodies (oracle-fallback docs).  Returns 0, or the required
//   capacity as a negative number minus one (caller regrows), or -1 on
//   malformed input (since -1 also means "need 0 bytes", capacity requests
//   use -(need)-2).
int64_t oppack_extract(
    const int32_t* export_buf, int32_t D, int32_t F, int32_t S, int32_t K,
    const uint8_t* arena_utf8, int64_t arena_bytes_len, int64_t arena_chars,
    const uint8_t* client_json, const int64_t* client_offs,
    const int32_t* client_doc_start,
    const uint8_t* key_json, const int64_t* key_offs,
    const int32_t* key_cols,
    const uint8_t* val_json, const int64_t* val_offs, int32_t n_vals,
    const int32_t* msn, const uint8_t* skip,
    int32_t not_removed,
    uint8_t* out, int64_t out_cap, int64_t* out_offs) {
    if (F != 12 + K + 1) return -1;
    // char → byte index over the arena (one pass).
    int64_t* idx = new int64_t[arena_chars + 1];
    {
        int64_t c = 0;
        for (int64_t i = 0; i < arena_bytes_len; ++i) {
            if ((arena_utf8[i] & 0xC0) != 0x80) {
                if (c > arena_chars) { delete[] idx; return -1; }
                idx[c++] = i;
            }
        }
        if (c != arena_chars) { delete[] idx; return -1; }
        idx[arena_chars] = arena_bytes_len;
    }

    int64_t w = 0;  // write cursor; keeps counting past capacity
    bool fits = true;
    bool bad = false;
    auto put = [&](const uint8_t* p, int64_t n) {
        if (fits && w + n <= out_cap) std::memcpy(out + w, p, n);
        else fits = false;
        w += n;
    };
    auto put_lit = [&](const char* s) {
        put(reinterpret_cast<const uint8_t*>(s), std::strlen(s));
    };
    auto put_int = [&](int64_t v) {
        char tmp[24];
        int n = 0;
        if (v < 0) { tmp[n++] = '-'; v = -v; }
        char digits[20];
        int nd = 0;
        do { digits[nd++] = static_cast<char>('0' + v % 10); v /= 10; }
        while (v > 0);
        while (nd > 0) tmp[n++] = digits[--nd];
        put(reinterpret_cast<const uint8_t*>(tmp), n);
    };
    // Escaped UTF-8 emit (ensure_ascii=False): passthrough except
    // '"', '\\' and control chars — exactly python json.dumps.
    auto put_escaped = [&](const uint8_t* tp, int64_t tn) {
        int64_t run = 0;
        for (int64_t i = 0; i < tn; ++i) {
            const uint8_t ch = tp[i];
            if (!(ch == '"' || ch == '\\' || ch < 0x20)) { ++run; continue; }
            if (run) put(tp + i - run, run);
            run = 0;
            switch (ch) {
                case '"': put_lit("\\\""); break;
                case '\\': put_lit("\\\\"); break;
                case '\b': put_lit("\\b"); break;
                case '\t': put_lit("\\t"); break;
                case '\n': put_lit("\\n"); break;
                case '\f': put_lit("\\f"); break;
                case '\r': put_lit("\\r"); break;
                default: {
                    char u[6];
                    static const char* hex = "0123456789abcdef";
                    u[0] = '\\'; u[1] = 'u'; u[2] = '0'; u[3] = '0';
                    u[4] = hex[(ch >> 4) & 0xF];
                    u[5] = hex[ch & 0xF];
                    put(reinterpret_cast<const uint8_t*>(u), 6);
                }
            }
        }
        if (run) put(tp + tn - run, run);
    };
    auto put_client = [&](int32_t d, int32_t c) {
        const int32_t ci = client_doc_start[d] + c;
        if (ci >= client_doc_start[d + 1]) { bad = true; return; }
        put(client_json + client_offs[ci],
            client_offs[ci + 1] - client_offs[ci]);
    };

    const int64_t fs = static_cast<int64_t>(F) * S;
    for (int32_t d = 0; d < D && !bad; ++d) {
        out_offs[d] = w;
        if (skip != nullptr && skip[d]) continue;
        const int32_t* ex = export_buf + static_cast<int64_t>(d) * fs;
        const int32_t* p_tstart = ex + 0 * S;
        const int32_t* p_tlen = ex + 1 * S;
        const int32_t* p_ins_seq = ex + 2 * S;
        const int32_t* p_ins_client = ex + 3 * S;
        const int32_t* p_rem_seq = ex + 4 * S;
        const int32_t* p_rem_client = ex + 5 * S;
        const int32_t* p_rem2_client = ex + 7 * S;
        const int32_t* p_ob1_seq = ex + 8 * S;
        const int32_t* p_ob1_client = ex + 9 * S;
        const int32_t* p_ob2_seq = ex + 10 * S;
        const int32_t* p_ob2_client = ex + 11 * S;
        const int32_t n = ex[static_cast<int64_t>(12 + K) * S + 0];
        const int32_t doc_msn = msn[d];
        if (n < 0 || n > S) { bad = true; break; }

        // In-window obliterate stamps pin a tombstone past normal expiry
        // (tail inserts resolve their arrival verdict against it).
        auto live_stamps = [&](int32_t s) {
            int32_t count = 0;
            if (p_ob1_seq[s] != not_removed && p_ob1_seq[s] > doc_msn) ++count;
            if (p_ob2_seq[s] != not_removed && p_ob2_seq[s] > doc_msn) ++count;
            return count;
        };
        auto expired = [&](int32_t s) {
            const int32_t rs = p_rem_seq[s];
            return rs != not_removed && rs <= doc_msn &&
                   p_ins_seq[s] <= doc_msn && live_stamps(s) == 0;
        };
        // Merge-equality of two SURVIVING slots, mirroring
        // _extract_records: normalized (s, c), removal triple, overlap
        // remover, property row.  Expired tombstones between surviving
        // slots are invisible to the merge (python compares against the
        // last *emitted* record).
        auto meta_eq = [&](int32_t x, int32_t y) {
            const bool rx = p_rem_seq[x] != not_removed;
            const bool ry = p_rem_seq[y] != not_removed;
            const bool cx = p_ins_seq[x] <= doc_msn;
            const bool cy = p_ins_seq[y] <= doc_msn;
            if ((cx ? 0 : p_ins_seq[x]) != (cy ? 0 : p_ins_seq[y])) {
                return false;
            }
            if ((cx ? -1 : p_ins_client[x]) != (cy ? -1 : p_ins_client[y])) {
                return false;
            }
            if (rx != ry) return false;
            if (rx && (p_rem_seq[x] != p_rem_seq[y] ||
                       p_rem_client[x] != p_rem_client[y])) {
                return false;
            }
            if (p_rem2_client[x] != p_rem2_client[y]) return false;
            // in-window stamp lists must match
            const bool o1x = p_ob1_seq[x] != not_removed &&
                             p_ob1_seq[x] > doc_msn;
            const bool o1y = p_ob1_seq[y] != not_removed &&
                             p_ob1_seq[y] > doc_msn;
            const bool o2x = p_ob2_seq[x] != not_removed &&
                             p_ob2_seq[x] > doc_msn;
            const bool o2y = p_ob2_seq[y] != not_removed &&
                             p_ob2_seq[y] > doc_msn;
            if (o1x != o1y || o2x != o2y) return false;
            if (o1x && (p_ob1_seq[x] != p_ob1_seq[y] ||
                        p_ob1_client[x] != p_ob1_client[y])) return false;
            if (o2x && (p_ob2_seq[x] != p_ob2_seq[y] ||
                        p_ob2_client[x] != p_ob2_client[y])) return false;
            for (int32_t k = 0; k < K; ++k) {
                if (ex[(12 + static_cast<int64_t>(k)) * S + x] !=
                    ex[(12 + static_cast<int64_t>(k)) * S + y]) {
                    return false;
                }
            }
            return true;
        };

        put_lit("[");
        bool first_rec = true;
        int32_t s = 0;
        while (s < n && !bad) {
            if (expired(s)) { ++s; continue; }
            // Gather the merge group: surviving slots equal to s, skipping
            // expired tombstones in between.
            // Two passes, no buffer: find the group end (cur), then emit
            // text by re-walking [s, cur) and skipping expired slots.
            int32_t cur = s + 1;
            while (cur < n) {
                if (expired(cur)) { ++cur; continue; }
                if (!meta_eq(s, cur)) break;
                ++cur;
            }

            const bool removed = p_rem_seq[s] != not_removed;
            const bool clamp = p_ins_seq[s] <= doc_msn;
            const int32_t seq_out = clamp ? 0 : p_ins_seq[s];
            const int32_t c_out = clamp ? -1 : p_ins_client[s];

            if (!first_rec) put_lit(",");
            first_rec = false;
            put_lit("{\"c\":");
            if (c_out < 0) put_lit("null");
            else put_client(d, c_out);
            if (live_stamps(s) > 0) {
                put_lit(",\"ob\":[");
                bool first_ob = true;
                const int32_t ob_seqs[2] = {p_ob1_seq[s], p_ob2_seq[s]};
                const int32_t ob_clients[2] = {p_ob1_client[s],
                                               p_ob2_client[s]};
                for (int i = 0; i < 2; ++i) {
                    if (ob_seqs[i] == not_removed || ob_seqs[i] <= doc_msn)
                        continue;
                    if (!first_ob) put_lit(",");
                    first_ob = false;
                    put_lit("[");
                    put_int(ob_seqs[i]);
                    put_lit(",");
                    put_client(d, ob_clients[i]);
                    put_lit("]");
                }
                put_lit("]");
            }
            bool has_props = false;
            for (int32_t k = 0; k < K && !has_props; ++k) {
                has_props = ex[(12 + static_cast<int64_t>(k)) * S + s] >= 0;
            }
            if (has_props) {
                put_lit(",\"p\":{");
                bool first_p = true;
                for (int32_t k = 0; k < K; ++k) {  // sorted key order
                    const int32_t col = key_cols[k];
                    const int32_t vid =
                        ex[(12 + static_cast<int64_t>(col)) * S + s];
                    if (vid < 0) continue;
                    if (vid >= n_vals) { bad = true; break; }
                    if (!first_p) put_lit(",");
                    first_p = false;
                    put(key_json + key_offs[k],
                        key_offs[k + 1] - key_offs[k]);
                    put_lit(":");
                    put(val_json + val_offs[vid],
                        val_offs[vid + 1] - val_offs[vid]);
                }
                put_lit("}");
            }
            if (removed) {
                put_lit(",\"rc\":");
                if (p_rem_client[s] < 0) put_lit("null");
                else put_client(d, p_rem_client[s]);
            }
            if (p_rem2_client[s] >= 0) {
                put_lit(",\"ro\":[");
                put_client(d, p_rem2_client[s]);
                put_lit("]");
            }
            if (removed) {
                put_lit(",\"rs\":");
                put_int(p_rem_seq[s]);
            }
            put_lit(",\"s\":");
            put_int(seq_out);
            put_lit(",\"t\":\"");
            for (int32_t g = s; g < cur && !bad; ++g) {
                if (expired(g)) continue;
                const int64_t c0 = p_tstart[g];
                const int64_t cl = p_tlen[g];
                if (c0 < 0 || c0 + cl > arena_chars) { bad = true; break; }
                put_escaped(arena_utf8 + idx[c0], idx[c0 + cl] - idx[c0]);
            }
            put_lit("\"}");
            s = cur;
        }
        put_lit("]");
    }
    delete[] idx;
    if (bad) return -1;
    out_offs[D] = w;
    if (!fits) return -w - 2;
    return 0;
}

// oppack_widen — undo the export transfer encodings in one native pass:
// narrow (int16 / int8-pair) source buffer → the canonical [D, R_canon, S]
// int32 layout mergetree_kernel.widen_export produces (byte-identical;
// pinned by tests).  Replaces the numpy widen on the extraction hot path.
//
// desc: R_canon rows × 4 int32 = [mode, arg, fill, flags]
//   mode 0 = FILL      (constant `fill`)
//   mode 1 = ROW16     (arg = source row; int16 elements)
//   mode 2 = PAIR8     (arg = src_row * 2 + half; int16 lane holds two
//                       int8 values, half 0 = high byte, 1 = low byte)
//   mode 3 = MISC      (stitch misc[d, j] for j < misc_cols, else 0)
// flags bit0: remap sentinel_src → sentinel_dst
// flags bit1: re-add doc_base[d] on slots < n (live-slot tstart rebase);
//             n is read from the canonical misc row (always last, col 0).
int32_t oppack_widen(
    const int16_t* src, int32_t D, int32_t S,
    int32_t R_src, int32_t R_canon,
    const int16_t* misc, int32_t misc_cols,
    const int32_t* desc,
    const int32_t* doc_base,
    int32_t sentinel_src, int32_t sentinel_dst,
    int32_t* dst) {
    // Validate the desc table up front, like the per-doc `n` check below:
    // a source-row index past R_src (ROW16 directly, PAIR8 via arg/2) or a
    // MISC row without the misc output would read out of bounds.  -1, not
    // UB, on a malformed table.
    for (int32_t r = 0; r < R_canon; ++r) {
        const int32_t mode = desc[r * 4 + 0];
        const int32_t arg = desc[r * 4 + 1];
        if (mode == 1 && (arg < 0 || arg >= R_src)) return -1;
        if (mode == 2 && (arg < 0 || arg / 2 >= R_src)) return -1;
        if (mode == 3 && misc == nullptr) return -1;
        if (mode < 0 || mode > 3) return -1;
    }
    const int64_t src_doc = static_cast<int64_t>(R_src) * S;
    const int64_t dst_doc = static_cast<int64_t>(R_canon) * S;
    for (int32_t d = 0; d < D; ++d) {
        const int16_t* sp = src + static_cast<int64_t>(d) * src_doc;
        int32_t* dp = dst + static_cast<int64_t>(d) * dst_doc;
        // n for the live-slot rebase: misc col 0 (separate misc output in
        // the pair layout, last source row otherwise).
        const int32_t n = misc != nullptr
            ? misc[static_cast<int64_t>(d) * misc_cols + 0]
            : sp[static_cast<int64_t>(R_src - 1) * S + 0];
        if (n < 0 || n > S) return -1;
        for (int32_t r = 0; r < R_canon; ++r) {
            const int32_t mode = desc[r * 4 + 0];
            const int32_t arg = desc[r * 4 + 1];
            const int32_t fill = desc[r * 4 + 2];
            const int32_t flags = desc[r * 4 + 3];
            int32_t* row = dp + static_cast<int64_t>(r) * S;
            if (mode == 0) {
                for (int32_t s = 0; s < S; ++s) row[s] = fill;
                continue;
            }
            if (mode == 3) {
                for (int32_t s = 0; s < S; ++s)
                    row[s] = s < misc_cols
                        ? misc[static_cast<int64_t>(d) * misc_cols + s] : 0;
                continue;
            }
            if (mode == 1) {
                const int16_t* srow = sp + static_cast<int64_t>(arg) * S;
                for (int32_t s = 0; s < S; ++s) row[s] = srow[s];
            } else if (mode == 2) {
                const int16_t* srow =
                    sp + static_cast<int64_t>(arg / 2) * S;
                const bool hi = (arg % 2) == 0;
                for (int32_t s = 0; s < S; ++s) {
                    const uint16_t pair = static_cast<uint16_t>(srow[s]);
                    row[s] = static_cast<int8_t>(
                        hi ? (pair >> 8) : (pair & 0xFF));
                }
            } else {
                return -1;
            }
            if (flags & 1) {
                for (int32_t s = 0; s < S; ++s)
                    if (row[s] == sentinel_src) row[s] = sentinel_dst;
            }
            if ((flags & 2) && doc_base != nullptr) {
                const int32_t base = doc_base[d];
                for (int32_t s = 0; s < n; ++s) row[s] += base;
            }
        }
    }
    return 0;
}

}  // extern "C"
