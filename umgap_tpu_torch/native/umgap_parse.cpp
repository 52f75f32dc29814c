// Host parsers of the port's native ingest library: FASTQ/FASTA buffers
// parsed straight into padded DNA-code rows ready for the device.
//
// A copy of umgap_parse_fastq / umgap_parse_fasta and their helpers from
// the JAX package's native host runtime (the port builds and loads none
// of its files); its index-build entries are not copied. Built with
// umgap_stream.cpp into one library by io/native.py at first use.

#include <cstdint>
#include <cstring>

namespace {

// DNA codes: A=0 C=1 G=2 T=3, everything else N=4
// (reference src/dna/mod.rs:34-44).
struct DnaTable {
    unsigned char t[256];
    DnaTable() {
        memset(t, 4, sizeof(t));
        t[(unsigned char)'A'] = 0;
        t[(unsigned char)'C'] = 1;
        t[(unsigned char)'G'] = 2;
        t[(unsigned char)'T'] = 3;
    }
};
const DnaTable kDna;

inline const char* find_eol(const char* p, const char* end) {
    const char* nl = (const char*)memchr(p, '\n', (size_t)(end - p));
    return nl ? nl : end;
}

}  // namespace

extern "C" {

// Parse a FASTQ buffer and encode reads as padded DNA codes.
//
//   buf, n       : whole-file buffer
//   out_codes    : cap_reads * max_len bytes, prefilled by caller (N=4)
//   out_lens     : cap_reads int32 (TRUE sequence length, NOT clipped;
//                  only the code rows are clipped at max_len)
//   hdr_starts/hdr_ends : byte spans of each header (without '@')
//   returns      : number of reads parsed, or -1 on malformed input
long umgap_parse_fastq(const char* buf, long n,
                       unsigned char* out_codes, int* out_lens, long max_len,
                       long* hdr_starts, long* hdr_ends, long cap_reads) {
    const char* p = buf;
    const char* end = buf + n;
    long count = 0;
    while (p < end) {
        if (*p != '@') return -1;
        const char* hstart = p + 1;
        const char* eol = find_eol(p, end);
        const char* hend = eol;
        if (hend > hstart && hend[-1] == '\r') hend--;
        p = eol < end ? eol + 1 : end;
        if (count >= cap_reads) return count;  // caller re-invokes
        hdr_starts[count] = hstart - buf;
        hdr_ends[count] = hend - buf;
        // sequence lines until '+'
        unsigned char* row = out_codes + count * max_len;
        long len = 0;
        while (p < end && *p != '+') {
            eol = find_eol(p, end);
            const char* sline_end = eol;
            if (sline_end > p && sline_end[-1] == '\r') sline_end--;
            for (const char* q = p; q < sline_end; q++) {
                if (len < max_len) row[len] = kDna.t[(unsigned char)*q];
                len++;
            }
            p = eol < end ? eol + 1 : end;
        }
        long nseq_chars = len;
        out_lens[count] = (int)len;  // TRUE length; codes clipped at max_len
                                     // (host clamps and can re-bucket)
        // '+' separator line
        if (p < end && *p == '+') {
            eol = find_eol(p, end);
            p = eol < end ? eol + 1 : end;
        }
        // quality: same number of characters as the sequence (line
        // structure may differ; consume lines until enough chars)
        long qchars = 0;
        while (p < end && qchars < nseq_chars) {
            eol = find_eol(p, end);
            const char* qline_end = eol;
            if (qline_end > p && qline_end[-1] == '\r') qline_end--;
            qchars += qline_end - p;
            p = eol < end ? eol + 1 : end;
        }
        count++;
    }
    return count;
}

// Parse a FASTA buffer: records with concatenated sequence lines
// (unwrap=true semantics, reference src/io/fasta.rs:62-64).
long umgap_parse_fasta(const char* buf, long n,
                       unsigned char* out_codes, int* out_lens, long max_len,
                       long* hdr_starts, long* hdr_ends, long cap_reads) {
    const char* p = buf;
    const char* end = buf + n;
    long count = -1;
    while (p < end) {
        const char* eol = find_eol(p, end);
        const char* line_end = eol;
        if (line_end > p && line_end[-1] == '\r') line_end--;
        if (*p == '>') {
            count++;
            if (count >= cap_reads) return count;
            hdr_starts[count] = (p + 1) - buf;
            hdr_ends[count] = line_end - buf;
            out_lens[count] = 0;
        } else if (count >= 0) {
            unsigned char* row = out_codes + count * max_len;
            long len = out_lens[count];
            for (const char* q = p; q < line_end; q++) {
                if (len < max_len) row[len] = kDna.t[(unsigned char)*q];
                len++;
            }
            out_lens[count] = (int)len;  // TRUE length (see fastq above)
        } else {
            return -1;  // content before first header
        }
        p = eol < end ? eol + 1 : end;
    }
    return count + 1;
}

}  // extern "C"
