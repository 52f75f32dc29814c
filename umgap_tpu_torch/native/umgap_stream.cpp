// GIL-free streaming batch assembly for the analyse fast path: the
// port's copy of the JAX package's streaming batch assembler (the port
// builds and loads none of the JAX package's native files).
//
// The reference overlaps parse with lookup via rayon threads and a 10MB
// input buffer (reference src/io/fasta.rs:14,
// src/commands/prot2kmer2lca.rs:166).  The Python host cannot do the
// same — a parse prefetch thread loses to GIL contention on a host with
// few cores — so the producer lives here instead: a C++ thread reads
// (possibly gzipped) FASTQ/FASTA, encodes and packs reads directly into
// a ring of pre-allocated device-wire batches (4-bit packed DNA, two
// bases per byte, first base in the high nibble — matching
// umgap_tpu_torch.ops.encoding.pack_dna4), and Python only dispatches
// ready buffers.  The output side mirrors it: a formatter turns (header
// blob, taxa) into the final ">hdr\ntaxon\n" bytes in one call.
//
// Strictly 4-line FASTQ records only (all real-world FASTQ; the Python
// readers accept multi-line records): violations flip the stream into
// status=unsupported and the caller hands the sample to the next ingest
// tier, exactly like io/native.py's chunked parser.

#include <zlib.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr int kStatusOk = 0;
constexpr int kStatusUnsupported = 2;
constexpr int kStatusIo = 3;

struct LineReader {
    gzFile f = nullptr;
    std::vector<char> buf;
    size_t pos = 0, len = 0;
    bool eof = false, fail = false;

    explicit LineReader(const char* path) : buf(1 << 20) {
        f = gzopen(path, "rb");  // transparently handles plain files
        if (!f) fail = true;
    }
    ~LineReader() {
        if (f) gzclose(f);
    }
    bool fill() {
        if (eof || fail) return false;
        int n = gzread(f, buf.data(), (unsigned)buf.size());
        if (n < 0) {
            fail = true;
            return false;
        }
        if (n == 0) {
            eof = true;
            return false;
        }
        pos = 0;
        len = (size_t)n;
        return true;
    }
    // next line without trailing newline; false on EOF-with-no-data
    bool next_line(std::string& out) {
        out.clear();
        for (;;) {
            if (pos >= len) {
                if (!fill()) return !out.empty() && !fail;
            }
            char* start = buf.data() + pos;
            char* nl = (char*)memchr(start, '\n', len - pos);
            if (nl) {
                out.append(start, nl - start);
                pos = (size_t)(nl - buf.data()) + 1;
                if (!out.empty() && out.back() == '\r') out.pop_back();
                return true;
            }
            out.append(start, len - pos);
            pos = len;
        }
    }
};

struct Slot {
    std::vector<uint8_t> dna;     // batch * ends * pw, prefilled 0x44
    std::vector<int32_t> lens;    // batch * ends
    std::vector<char> hdr;        // concatenated stripped headers
    std::vector<long long> hoff;  // batch + 1 offsets into hdr
    int n = 0;
    int true_max = 0;
};

uint8_t g_code[256];

struct Stream {
    std::vector<Slot> slots;
    std::deque<int> ready;
    std::deque<int> free_slots;
    std::mutex mu;
    std::condition_variable cv_ready, cv_free;
    std::thread th;
    std::atomic<bool> quit{false};
    bool done = false;   // producer finished (EOF or error)
    int status = kStatusOk;
    int batch, ends, L, pw, fmt;
    char delim;
    int current = -1;  // slot handed to the consumer, recycled on next()
    std::vector<std::string> paths;

    void reset_slot(Slot& s) {
        memset(s.dna.data(), 0x44, s.dna.size());
        memset(s.lens.data(), 0, s.lens.size() * sizeof(int32_t));
        s.hdr.clear();
        s.hoff.clear();
        s.hoff.push_back(0);
        s.n = 0;
        s.true_max = 0;
    }

    void put_seq(Slot& s, int row, int end, const std::string& seq) {
        size_t n = seq.size();
        if ((int)n > s.true_max) s.true_max = (int)n;
        if (n > (size_t)L) n = (size_t)L;
        s.lens[(size_t)row * ends + end] = (int32_t)n;
        uint8_t* dst = s.dna.data() + ((size_t)row * ends + end) * pw;
        size_t i = 0;
        for (; i + 1 < n; i += 2)
            dst[i >> 1] = (uint8_t)((g_code[(uint8_t)seq[i]] << 4)
                                    | g_code[(uint8_t)seq[i + 1]]);
        if (i < n)
            dst[i >> 1] = (uint8_t)((g_code[(uint8_t)seq[i]] << 4) | 4);
    }

    void put_header(Slot& s, const std::string& line) {
        // line includes the '@'/'>' marker at [0]; strip at delim
        size_t start = 1, stop = line.size();
        for (size_t i = start; i < line.size(); i++)
            if (line[i] == delim) {
                stop = i;
                break;
            }
        s.hdr.insert(s.hdr.end(), line.begin() + start, line.begin() + stop);
        s.hoff.push_back((long long)s.hdr.size());
    }

    // one FASTQ record; 1 ok, 0 clean EOF, -1 bad
    int read_fastq(LineReader& r, std::string& h, std::string& seq,
                   std::string& tmp) {
        if (!r.next_line(h)) return r.fail ? -1 : 0;
        if (h.empty() || h[0] != '@') return -1;
        if (!r.next_line(seq)) return -1;
        if (!r.next_line(tmp) || tmp.empty() || tmp[0] != '+') return -1;
        if (!r.next_line(tmp)) return -1;
        if (tmp.size() != seq.size()) return -1;  // multi-line record
        return 1;
    }

    // one FASTA record (multi-line sequences concatenate); carry holds
    // the lookahead header line between calls
    int read_fasta(LineReader& r, std::string& h, std::string& seq,
                   std::string& carry) {
        if (carry.empty()) {
            if (!r.next_line(carry)) return r.fail ? -1 : 0;
        }
        if (carry.empty() || carry[0] != '>') return -1;
        h = carry;
        carry.clear();
        seq.clear();
        std::string line;
        for (;;) {
            if (!r.next_line(line)) {
                if (r.fail) return -1;
                return 1;
            }
            if (!line.empty() && line[0] == '>') {
                carry = line;
                return 1;
            }
            seq += line;
        }
    }

    int acquire_free() {
        std::unique_lock<std::mutex> lk(mu);
        cv_free.wait(lk, [&] { return !free_slots.empty() || quit; });
        if (quit) return -1;
        int s = free_slots.front();
        free_slots.pop_front();
        return s;
    }

    void publish(int idx, bool last, int st) {
        std::lock_guard<std::mutex> lk(mu);
        if (slots[idx].n > 0)
            ready.push_back(idx);
        else
            free_slots.push_back(idx);
        if (last) {
            done = true;
            status = st;
        }
        cv_ready.notify_all();
    }

    void run() {
        std::vector<LineReader> readers;
        readers.reserve(paths.size());
        for (auto& p : paths) readers.emplace_back(p.c_str());
        for (auto& r : readers)
            if (r.fail) {
                publish_empty(kStatusIo);
                return;
            }
        std::string h, h2, seq, tmp;
        std::vector<std::string> carry(paths.size());
        for (;;) {
            int idx = acquire_free();
            if (idx < 0) return;  // consumer closed
            Slot& s = slots[idx];
            reset_slot(s);
            while (s.n < batch) {
                int rc;
                if (fmt == 0)
                    rc = read_fastq(readers[0], h, seq, tmp);
                else
                    rc = read_fasta(readers[0], h, seq, carry[0]);
                if (rc <= 0) {
                    publish(idx, true, rc < 0 ? bad_status(readers[0])
                                              : kStatusOk);
                    return;
                }
                put_header(s, h);
                put_seq(s, s.n, 0, seq);
                for (int e = 1; e < ends; e++) {
                    rc = read_fastq(readers[e], h2, seq, tmp);
                    if (rc <= 0) {
                        // zip-shortest: drop the half-read group
                        s.hdr.resize((size_t)s.hoff[s.n]);
                        s.hoff.resize((size_t)s.n + 1);
                        publish(idx, true, rc < 0 ? bad_status(readers[e])
                                                  : kStatusOk);
                        return;
                    }
                    put_seq(s, s.n, e, seq);
                }
                s.n++;
            }
            publish(idx, false, kStatusOk);
            if (quit) return;
        }
    }

    int bad_status(LineReader& r) {
        return r.fail ? kStatusIo : kStatusUnsupported;
    }

    void publish_empty(int st) {
        std::lock_guard<std::mutex> lk(mu);
        done = true;
        status = st;
        cv_ready.notify_all();
    }
};

}  // namespace

extern "C" {

void* umgap_stream_open(const char* path1, const char* path2, int fmt,
                        int read_length, int batch, int ends, int n_slots,
                        char delim) {
    static std::once_flag once;
    std::call_once(once, [] {
        memset(g_code, 4, sizeof(g_code));
        g_code[(uint8_t)'A'] = 0;
        g_code[(uint8_t)'C'] = 1;
        g_code[(uint8_t)'G'] = 2;
        g_code[(uint8_t)'T'] = 3;
        g_code[(uint8_t)'a'] = 0;
        g_code[(uint8_t)'c'] = 1;
        g_code[(uint8_t)'g'] = 2;
        g_code[(uint8_t)'t'] = 3;
    });
    auto* st = new Stream();
    st->batch = batch;
    st->ends = ends;
    st->L = read_length;
    st->pw = (read_length + 1) / 2;
    st->fmt = fmt;
    st->delim = delim;
    st->paths.emplace_back(path1);
    if (path2 && *path2) st->paths.emplace_back(path2);
    if ((int)st->paths.size() != ends || n_slots < 2) {
        delete st;
        return nullptr;
    }
    st->slots.resize(n_slots);
    for (int i = 0; i < n_slots; i++) {
        st->slots[i].dna.resize((size_t)batch * ends * st->pw);
        st->slots[i].lens.resize((size_t)batch * ends);
        st->free_slots.push_back(i);
    }
    st->th = std::thread([st] { st->run(); });
    return st;
}

// Returns records in the next ready slot (pointers valid until the next
// call), 0 on clean EOF, -2 input unsupported for this fast path, -3 IO
// error.  Blocks (no GIL held on the Python side: ctypes releases it).
long long umgap_stream_next(void* handle, const uint8_t** dna,
                            const int32_t** lens, const char** hdr,
                            const long long** hoff, long long* hdr_len,
                            int* true_max) {
    auto* st = (Stream*)handle;
    std::unique_lock<std::mutex> lk(st->mu);
    if (st->current >= 0) {
        st->free_slots.push_back(st->current);
        st->current = -1;
        st->cv_free.notify_all();
    }
    st->cv_ready.wait(lk, [&] { return !st->ready.empty() || st->done; });
    if (st->ready.empty()) {
        if (st->status == kStatusUnsupported) return -2;
        if (st->status == kStatusIo) return -3;
        return 0;
    }
    int idx = st->ready.front();
    st->ready.pop_front();
    st->current = idx;
    Slot& s = st->slots[idx];
    *dna = s.dna.data();
    *lens = s.lens.data();
    *hdr = s.hdr.data();
    *hoff = s.hoff.data();
    *hdr_len = (long long)s.hdr.size();
    *true_max = s.true_max;
    return s.n;
}

void umgap_stream_close(void* handle) {
    auto* st = (Stream*)handle;
    {
        std::lock_guard<std::mutex> lk(st->mu);
        st->quit = true;
        st->cv_free.notify_all();
    }
    if (st->th.joinable()) st->th.join();
    delete st;
}

// (header blob, offsets, per-record taxa) -> ">hdr\ntaxon\n" bytes.
// Returns bytes written, or the REQUIRED capacity (> cap) when out is
// too small — caller resizes and retries.
long long umgap_format_output(const char* hdr, const long long* hoff,
                              const int32_t* taxa, long long n, char* out,
                              long long cap) {
    long long need = hoff[n] + n * 14;  // '>', '\n', int32 + '\n'
    if (need > cap) return need;
    char* p = out;
    for (long long i = 0; i < n; i++) {
        *p++ = '>';
        long long hl = hoff[i + 1] - hoff[i];
        memcpy(p, hdr + hoff[i], (size_t)hl);
        p += hl;
        *p++ = '\n';
        int32_t t = taxa[i];
        if (t < 0) {
            *p++ = '-';
            t = -t;
        }
        char tmp[12];
        int k = 0;
        do {
            tmp[k++] = (char)('0' + t % 10);
            t /= 10;
        } while (t);
        while (k) *p++ = tmp[--k];
        *p++ = '\n';
    }
    return (long long)(p - out);
}

}  // extern "C"
