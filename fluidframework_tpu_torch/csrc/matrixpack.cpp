// libmatrixpack — native pack of SharedMatrix message records for the
// matrix axis fold (K4), and the canonical summaries of its result.
//
// The host half of bulk SharedMatrix catch-up turns each document's
// sequenced messages into the two axis op streams the fold reads (the
// document's rows at stream 2d, its columns at 2d + 1;
// ops/matrix_kernel.py::pack_matrix_batch), then, from the fold's final
// axis planes and the handle each setCell resolved to, writes the summary
// (summary_from_matrix_state).  The ingestion side encodes a document's
// messages once into the record stream below
// (ops/matrix_native.py::encode_matrix_ops); this library fills the op
// planes from those records with no Python object in the loop, bit for bit
// what the Python pack fills, and writes the summaries byte for byte.
//
// Record layout (little-endian, packed), one document a stream:
//   header, 8 x i32:
//     magic 0x3158524D, n_msgs, n_values, n_clients,
//     n_cells (setCell messages), row_rows, col_rows (the rows of each
//     axis stream: its inserts and removes and one row a setCell),
//     flags (bit 0: a message has no client; bit 1: timestamps follow)
//   n_msgs messages, 9 x i32 each:
//     seq, client_seq, ref_seq, min_seq,
//     client   (index into the client table; -1: none)
//     kind     (1 insertRows, 2 insertCols, 3 removeRows, 4 removeCols,
//               5 setCell, 6 setPolicy)
//     a, b     (insert: pos, count; remove: start, end; setCell: row, col;
//               setPolicy: 0, 0)
//     value    (setCell: index into the value table; else -1)
//   [flags bit 1] n_msgs f64 timestamps
//   (n_values + 1) i32 offsets of each value's JSON in the value section,
//   (n_clients + 1) i32 offsets of each client's JSON in the client section,
//   the value section: each value's canonical JSON, back to back,
//   the client section: each client id's JSON string, back to back.
//
// API (C ABI, ctypes-consumed; the interpreter lock is released around
// every call):
//   matrixpack_fill(...)    — the op planes and cell tables of a doc range
//   matrixpack_extract(...) — final axis planes → header and body blobs
//   matrixpack_size(...)    — the bytes an extract wrote
//   matrixpack_take(...)    — copy them out and release the extract
//
// matrixpack_extract writes, per document, the exact bytes of
// canonical_json(header) and canonical_json(body) that
// matrix_kernel.summary_from_matrix_state builds from the same planes:
// sorted keys, minimal separators, the values' and clients' JSON as the
// tables hold it.  A document that route would treat otherwise (an axis
// that overflowed, a slot count past the downloaded width, a client or
// value index outside its table, a handle past the axis' handles) gets a
// nonzero status and no bytes: the caller takes the Python route for it.

#include <algorithm>
#include <charconv>
#include <climits>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int32_t kMagic = 0x3158524D;
constexpr int kHeaderFields = 8;
constexpr int kMsgFields = 9;
constexpr int32_t kNotRemoved = INT32_MAX;
constexpr int32_t kPropNotTouched = -2;

// record kinds
constexpr int32_t kInsertRows = 1, kInsertCols = 2, kRemoveRows = 3,
                  kRemoveCols = 4, kSetCell = 5, kSetPolicy = 6;
// the fold's row kinds (mergetree_kernel.K_*, matrix_kernel.K_RESOLVE)
constexpr int32_t kKInsert = 1, kKRemove = 2, kKResolve = 5;

// the op planes, in MTOps field order
enum Plane { P_KIND, P_SEQ, P_CLIENT, P_REF, P_MIN, P_A, P_B, P_TSTART,
             P_TLEN, P_PVALS, N_PLANES };
// a cell row: seq, ref_seq, client, value, row stream row, col stream row
constexpr int kCellFields = 6;
constexpr int kFacts = 4;

// the writer's planes, in its order
enum WPlane { W_TSTART, W_TLEN, W_INS_SEQ, W_INS_CLIENT, W_REM_SEQ,
              W_REM_CLIENT, W_REM2_CLIENT, N_WPLANES };

// writer statuses
constexpr int32_t kWritten = 0, kOverflow = 1, kOutside = 2;

struct Doc {
    const int32_t* head = nullptr;
    const int32_t* msgs = nullptr;
    const int32_t* value_offs = nullptr;
    const int32_t* client_offs = nullptr;
    const char* values = nullptr;
    const char* clients = nullptr;
    int32_t n_msgs = 0, n_values = 0, n_clients = 0;

    // Reads a record stream's header and sections; false when malformed.
    bool parse(const uint8_t* blob, int64_t len) {
        if (len < 4 * kHeaderFields) return false;
        head = reinterpret_cast<const int32_t*>(blob);
        int32_t h[kHeaderFields];
        std::memcpy(h, blob, sizeof h);
        if (h[0] != kMagic || h[1] < 0 || h[2] < 0 || h[3] < 0) return false;
        n_msgs = h[1];
        n_values = h[2];
        n_clients = h[3];
        int64_t off = 4 * kHeaderFields;
        msgs = reinterpret_cast<const int32_t*>(blob + off);
        off += int64_t(4) * kMsgFields * n_msgs;
        if (h[7] & 2) off += int64_t(8) * n_msgs;
        const int64_t tables = int64_t(4) * (n_values + 1 + n_clients + 1);
        if (off + tables > len) return false;
        value_offs = reinterpret_cast<const int32_t*>(blob + off);
        client_offs = value_offs + n_values + 1;
        off += tables;
        values = reinterpret_cast<const char*>(blob + off);
        if (!monotone(value_offs, n_values, len - off)) return false;
        off += value_offs[n_values];
        clients = reinterpret_cast<const char*>(blob + off);
        if (!monotone(client_offs, n_clients, len - off)) return false;
        return off + client_offs[n_clients] == len;
    }

    static bool monotone(const int32_t* offs, int32_t n, int64_t room) {
        if (offs[0] != 0) return false;
        for (int32_t i = 0; i < n; ++i)
            if (offs[i + 1] < offs[i]) return false;
        return offs[n] <= room;
    }

    int32_t msg(int32_t i, int f) const {
        int32_t v;
        std::memcpy(&v, msgs + int64_t(i) * kMsgFields + f, 4);
        return v;
    }
    int32_t header(int f) const {
        int32_t v;
        std::memcpy(&v, head + f, 4);
        return v;
    }
};

// Fills document `doc`'s two streams (rows `row` and `row + 1` of every
// plane, T wide) and its cell rows; its facts: the policy switch's seq (-1
// none), the row and column handles allocated, the cells.  Returns 0, -1
// for a malformed stream, -2 for a stream longer than T.
int fill_doc(const Doc& doc, int64_t row, int32_t T, int32_t* const* planes,
             int32_t* cells, int32_t* facts) {
    int32_t* r[N_PLANES];
    int32_t* c[N_PLANES];
    for (int p = 0; p < N_PLANES; ++p) {
        r[p] = planes[p] + row * T;
        c[p] = planes[p] + (row + 1) * T;
    }
    int32_t t_row = 0, t_col = 0, n_cells = 0, fww = -1;
    int32_t handles[2] = {0, 0};
    for (int32_t i = 0; i < doc.n_msgs; ++i) {
        const int32_t seq = doc.msg(i, 0), ref = doc.msg(i, 2),
                      client = doc.msg(i, 4), kind = doc.msg(i, 5),
                      a = doc.msg(i, 6), b = doc.msg(i, 7),
                      value = doc.msg(i, 8);
        if (client < -1 || client >= doc.n_clients) return -1;
        if (kind == kSetPolicy) {
            if (fww < 0) fww = seq;
            continue;
        }
        if (kind == kSetCell) {
            // the cell rows were sized from the header's count
            if (value < 0 || value >= doc.n_values ||
                n_cells >= doc.header(4))
                return -1;
            if (t_row >= T || t_col >= T) return -2;
            for (int s = 0; s < 2; ++s) {
                int32_t** q = s ? c : r;
                const int32_t t = s ? t_col : t_row;
                q[P_KIND][t] = kKResolve;
                q[P_SEQ][t] = seq;
                q[P_CLIENT][t] = client;
                q[P_REF][t] = ref;
                q[P_MIN][t] = 0;
                q[P_A][t] = s ? b : a;
                q[P_B][t] = 0;
                q[P_TSTART][t] = 0;
                q[P_TLEN][t] = 0;
                q[P_PVALS][t] = kPropNotTouched;
            }
            int32_t* cell = cells + int64_t(n_cells) * kCellFields;
            cell[0] = seq;
            cell[1] = ref;
            cell[2] = client;
            cell[3] = value;
            cell[4] = t_row++;
            cell[5] = t_col++;
            ++n_cells;
            continue;
        }
        if (kind < kInsertRows || kind > kRemoveCols) return -1;
        const int axis = (kind == kInsertCols || kind == kRemoveCols);
        int32_t** q = axis ? c : r;
        int32_t& t = axis ? t_col : t_row;
        if (t >= T) return -2;
        q[P_SEQ][t] = seq;
        q[P_CLIENT][t] = client;
        q[P_REF][t] = ref;
        q[P_MIN][t] = 0;
        q[P_PVALS][t] = kPropNotTouched;
        q[P_A][t] = a;
        if (kind <= kInsertCols) {
            if (b < 0 || handles[axis] > INT32_MAX - b) return -1;
            q[P_KIND][t] = kKInsert;
            q[P_B][t] = 0;
            q[P_TSTART][t] = handles[axis];
            q[P_TLEN][t] = b;
            handles[axis] += b;
        } else {
            q[P_KIND][t] = kKRemove;
            q[P_B][t] = b;
            q[P_TSTART][t] = 0;
            q[P_TLEN][t] = 0;
        }
        ++t;
    }
    if (n_cells != doc.header(4) || t_row != doc.header(5) ||
        t_col != doc.header(6))
        return -1;
    for (int p = 0; p < N_PLANES; ++p) {
        const int32_t fill = p == P_PVALS ? kPropNotTouched : 0;
        std::fill(r[p] + t_row, r[p] + T, fill);
        std::fill(c[p] + t_col, c[p] + T, fill);
    }
    facts[0] = fww;
    facts[1] = handles[0];
    facts[2] = handles[1];
    facts[3] = n_cells;
    return 0;
}

// -- the summary writer -------------------------------------------------------

struct Out {
    std::vector<char> buf;

    void raw(const char* p, size_t n) { buf.insert(buf.end(), p, p + n); }
    void lit(const char* s) { raw(s, std::strlen(s)); }
    void ch(char c) { buf.push_back(c); }
    void num(int64_t v) {
        char tmp[24];
        auto res = std::to_chars(tmp, tmp + sizeof tmp, v);
        raw(tmp, res.ptr - tmp);
    }
};

// One slot of an axis as its canonical record sees it.
struct Rec {
    int64_t n;
    int32_t s, c, rs, rc, ro;  // c, rc, ro: client index, -1 none
    bool removed;

    bool same(const Rec& o) const {
        return s == o.s && c == o.c && removed == o.removed && rs == o.rs &&
               rc == o.rc && ro == o.ro;
    }
};

struct View {
    const int32_t* planes[N_WPLANES];
    int64_t W;
};

struct Cell {
    int64_t key;
    int32_t idx;
};

// The canonical records of one axis stream and its handle -> canonical id
// map (matrix_kernel._axis_records), and its visible count.  False when a
// slot names what the tables or the handle range do not hold.
bool axis_records(const View& v, int64_t base, int32_t n, int64_t msn,
                  int32_t n_clients, std::vector<Rec>& recs,
                  std::vector<int32_t>& hmap, int64_t& visible) {
    recs.clear();
    visible = 0;
    int64_t H = 0;
    for (int32_t s = 0; s < n; ++s) {
        const int64_t t0 = v.planes[W_TSTART][base + s],
                      tl = v.planes[W_TLEN][base + s];
        if (t0 < 0 || tl < 0) return false;
        H = std::max(H, t0 + tl);
    }
    if (H > (int64_t(1) << 30)) return false;
    hmap.assign(size_t(H), -1);
    int32_t next = 0;
    for (int32_t s = 0; s < n; ++s) {
        const int32_t rs = v.planes[W_REM_SEQ][base + s];
        const int32_t tl = v.planes[W_TLEN][base + s];
        const bool removed = rs != kNotRemoved;
        if (!removed) visible += tl;
        if (removed && rs <= msn) continue;
        const int32_t t0 = v.planes[W_TSTART][base + s];
        for (int32_t h = t0; h < t0 + tl; ++h) hmap[h] = next++;
        Rec rec{tl, 0, -1, 0, -1, -1, removed};
        const int32_t ins = v.planes[W_INS_SEQ][base + s];
        if (ins > msn) {
            const int32_t ic = v.planes[W_INS_CLIENT][base + s];
            if (ic < 0 || ic >= n_clients) return false;
            rec.s = ins;
            rec.c = ic;
        }
        if (removed) {
            const int32_t rc = v.planes[W_REM_CLIENT][base + s];
            if (rc >= n_clients) return false;
            rec.rs = rs;
            rec.rc = rc < 0 ? -1 : rc;
        }
        const int32_t rc2 = v.planes[W_REM2_CLIENT][base + s];
        if (rc2 >= n_clients) return false;
        rec.ro = rc2 < 0 ? -1 : rc2;
        if (!recs.empty() && recs.back().same(rec)) {
            recs.back().n += rec.n;
            continue;
        }
        recs.push_back(rec);
    }
    return true;
}

void client_json(Out& o, const Doc& doc, int32_t c) {
    if (c < 0) {
        o.lit("null");
        return;
    }
    o.raw(doc.clients + doc.client_offs[c],
          doc.client_offs[c + 1] - doc.client_offs[c]);
}

void write_records(Out& o, const Doc& doc, const std::vector<Rec>& recs) {
    o.ch('[');
    for (size_t i = 0; i < recs.size(); ++i) {
        const Rec& r = recs[i];
        if (i) o.ch(',');
        o.lit("{\"c\":");
        client_json(o, doc, r.c);
        o.lit(",\"n\":");
        o.num(r.n);
        if (r.removed) {
            o.lit(",\"rc\":");
            client_json(o, doc, r.rc);
        }
        if (r.ro >= 0) {
            o.lit(",\"ro\":[");
            client_json(o, doc, r.ro);
            o.ch(']');
        }
        if (r.removed) {
            o.lit(",\"rs\":");
            o.num(r.rs);
        }
        o.lit(",\"s\":");
        o.num(r.s);
        o.ch('}');
    }
    o.ch(']');
}

struct Extract {
    Out out;
};

}  // namespace

extern "C" {

// Fills documents [0, n_docs) of a range: document i's streams are rows
// 2i and 2i + 1 of each plane (`planes`: the ten [2D, T] int32 op planes
// in MTOps field order, pvals with K = 1, each pointing at the range's
// first row), its cell rows at `cells + 6 * cell_at[i]`, its facts at
// `facts + 4 * i`.  Returns 0, or -1 (malformed) / -2 (a stream longer
// than T) with `*bad` the range's first such document.
int matrixpack_fill(int32_t n_docs, const uint8_t* const* blobs,
                    const int64_t* lens, int32_t T, int32_t* const* planes,
                    int32_t* cells, const int64_t* cell_at, int32_t* facts,
                    int32_t* bad) {
    for (int32_t i = 0; i < n_docs; ++i) {
        Doc doc;
        int rc = doc.parse(blobs[i], lens[i]) ? 0 : -1;
        if (rc == 0)
            rc = fill_doc(doc, int64_t(2) * i, T, planes,
                          cells + kCellFields * cell_at[i],
                          facts + int64_t(kFacts) * i);
        if (rc != 0) {
            *bad = i;
            return rc;
        }
    }
    return 0;
}

// Writes the header and body blobs of the documents at `rows` of a
// downloaded slice: `planes` the seven [Dk, 2, W] int32 axis planes in the
// writer's order (tstart, tlen, ins_seq, ins_client, rem_seq, rem_client,
// rem2_client), `n` [Dk, 2] int32, `overflow` [Dk, 2] u8, `resolved`
// [Dk, 2, T] int32, all C-contiguous; per row its record stream, its cell
// rows `cells[cell_lo[j] : cell_hi[j]]`, its policy switch (`fww`, -1
// none), its head seq and min seq.  Per row j, `offs[2j] .. offs[2j + 1]`
// is the header and `offs[2j + 1] .. offs[2j + 2]` the body in the
// extract's bytes, `n_cells[j]` the cells the body holds and `status[j]`
// 0, or why the row was left to the Python route (no bytes).  Returns the
// extract, for matrixpack_size / matrixpack_take.
void* matrixpack_extract(int32_t k, const int32_t* rows,
                         const int32_t* const* planes, const int32_t* n,
                         const uint8_t* overflow, const int32_t* resolved,
                         int32_t W, int32_t T, const uint8_t* const* blobs,
                         const int64_t* lens, const int32_t* cells,
                         const int64_t* cell_lo, const int64_t* cell_hi,
                         const int32_t* fww, const int64_t* final_seq,
                         const int64_t* final_msn, int64_t* offs,
                         int64_t* n_cells, int32_t* status) {
    auto* ex = new Extract();
    Out& o = ex->out;
    View v;
    for (int p = 0; p < N_WPLANES; ++p) v.planes[p] = planes[p];
    v.W = W;
    std::vector<Rec> recs[2];
    std::vector<int32_t> hmap[2];
    std::vector<Cell> keyed;
    std::vector<int32_t> stored;  // per key group: the winning cell row
    std::vector<std::pair<int64_t, int32_t>> live;
    offs[0] = 0;
    for (int32_t j = 0; j < k; ++j) {
        const size_t mark = o.buf.size();
        const int64_t d = rows[j];
        const int64_t msn = final_msn[j];
        int32_t st = kWritten;
        Doc doc;
        if (!doc.parse(blobs[j], lens[j])) st = kOutside;
        int64_t visible[2] = {0, 0};
        for (int a = 0; a < 2 && st == kWritten; ++a) {
            if (overflow[2 * d + a]) {
                st = kOverflow;
                break;
            }
            const int32_t na = n[2 * d + a];
            if (na < 0 || na > W ||
                !axis_records(v, (2 * d + a) * W, na, msn, doc.n_clients,
                              recs[a], hmap[a], visible[a]))
                st = kOutside;
        }
        // The cell fold (matrix_kernel._fold_cells): each resolved cell
        // row by (row handle, column handle), in seq order within a key;
        // last writer wins, or, past the policy switch, a write loses to
        // a stored value sequenced after its view by another client.
        keyed.clear();
        live.clear();
        const int32_t* rv = resolved + 2 * d * int64_t(T);
        const int32_t* cv = rv + T;
        for (int64_t i = cell_lo[j]; i < cell_hi[j] && st == kWritten;
             ++i) {
            const int32_t* cell = cells + i * kCellFields;
            if (cell[3] < 0 || cell[3] >= doc.n_values || cell[2] < -1 ||
                cell[2] >= doc.n_clients || cell[4] < 0 || cell[4] >= T ||
                cell[5] < 0 || cell[5] >= T) {
                st = kOutside;
                break;
            }
            const int32_t rh = rv[cell[4]], chh = cv[cell[5]];
            if (rh < 0 || chh < 0) continue;
            keyed.push_back({(int64_t(rh) << 32) | uint32_t(chh),
                             int32_t(i - cell_lo[j])});
        }
        if (st == kWritten) {
            std::sort(keyed.begin(), keyed.end(),
                      [](const Cell& x, const Cell& y) {
                          return x.key != y.key ? x.key < y.key
                                                : x.idx < y.idx;
                      });
            const int32_t* base = cells + cell_lo[j] * kCellFields;
            for (size_t i = 0; i < keyed.size();) {
                size_t e = i;
                int32_t win = -1;
                for (; e < keyed.size() && keyed[e].key == keyed[i].key;
                     ++e) {
                    const int32_t* cell = base + keyed[e].idx * kCellFields;
                    if (win >= 0 && fww[j] >= 0 && cell[0] > fww[j]) {
                        const int32_t* w = base + win * kCellFields;
                        if (w[0] > cell[1] && w[2] != cell[2]) continue;
                    }
                    win = keyed[e].idx;
                }
                const int64_t rh = keyed[i].key >> 32;
                const int64_t chh = keyed[i].key & 0xFFFFFFFF;
                if (rh < int64_t(hmap[0].size()) &&
                    chh < int64_t(hmap[1].size()) && hmap[0][rh] >= 0 &&
                    hmap[1][chh] >= 0)
                    live.push_back({(int64_t(hmap[0][rh]) << 32) |
                                        uint32_t(hmap[1][chh]),
                                    win});
                i = e;
            }
            std::sort(live.begin(), live.end());
            o.lit("{\"cols\":");
            o.num(visible[1]);
            o.lit(",\"minSeq\":");
            o.num(msn);
            o.lit(fww[j] >= 0 ? ",\"policy\":\"fww\",\"rows\":"
                              : ",\"policy\":\"lww\",\"rows\":");
            o.num(visible[0]);
            o.lit(",\"seq\":");
            o.num(final_seq[j]);
            o.ch('}');
            offs[2 * j + 1] = int64_t(o.buf.size());
            o.lit("{\"cells\":[");
            for (size_t i = 0; i < live.size(); ++i) {
                const int32_t* cell = base + live[i].second * kCellFields;
                if (i) o.ch(',');
                o.ch('[');
                o.num(live[i].first >> 32);
                o.ch(',');
                o.num(live[i].first & 0xFFFFFFFF);
                o.ch(',');
                o.raw(doc.values + doc.value_offs[cell[3]],
                      doc.value_offs[cell[3] + 1] - doc.value_offs[cell[3]]);
                o.ch(',');
                if (cell[0] <= msn) {
                    o.lit("0,null]");
                    continue;
                }
                o.num(cell[0]);
                o.ch(',');
                client_json(o, doc, cell[2]);
                o.ch(']');
            }
            o.lit("],\"cols\":");
            write_records(o, doc, recs[1]);
            o.lit(",\"rows\":");
            write_records(o, doc, recs[0]);
            o.ch('}');
            n_cells[j] = int64_t(live.size());
        }
        if (st != kWritten) {
            o.buf.resize(mark);
            offs[2 * j + 1] = int64_t(mark);
            n_cells[j] = 0;
        }
        status[j] = st;
        offs[2 * j + 2] = int64_t(o.buf.size());
    }
    return ex;
}

int64_t matrixpack_size(void* handle) {
    return int64_t(static_cast<Extract*>(handle)->out.buf.size());
}

// Copies an extract's bytes to `dst` (matrixpack_size of them; null: none)
// and releases it.
void matrixpack_take(void* handle, uint8_t* dst) {
    auto* ex = static_cast<Extract*>(handle);
    if (dst != nullptr && !ex->out.buf.empty())
        std::memcpy(dst, ex->out.buf.data(), ex->out.buf.size());
    delete ex;
}

}  // extern "C"
