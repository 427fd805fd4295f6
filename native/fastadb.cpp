// Native FASTA parser + symbol packer for libssa_tpu.
//
// Counterpart of the reference's native database layer (libsdb +
// src/db_adapter.c per SURVEY.md §2): parse a FASTA database once, translate
// ASCII to internal symbol codes through a caller-supplied 256-entry table,
// and hand back flat packed arrays (codes / offsets / lengths / headers)
// ready for zero-copy adoption by NumPy. Single pass over an mmap'd file;
// throughput is memory-bound (~GB/s), an order of magnitude over the Python
// line parser, which matters when re-packing Swiss-Prot-scale databases.
//
// Build: make -C native   (produces libfastadb.so; loaded via ctypes from
// libssa_tpu/io/native.py, with a pure-Python fallback when absent).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct FastaDB {
  std::vector<uint8_t> codes;
  std::vector<int64_t> offsets;
  std::vector<int32_t> lengths;
  std::string headers;  // NUL-joined header lines (without '>')
};

inline bool is_residue(unsigned char c) {
  return (c >= 'A' && c <= 'Z') || (c >= 'a' && c <= 'z') || c == '*';
}

}  // namespace

extern "C" {

// Parse `path`, translating residues through `code_table` (256 entries,
// ASCII -> internal code). Returns an opaque handle, or nullptr on error.
void* fastadb_parse(const char* path, const uint8_t* code_table) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (::fstat(fd, &st) != 0) {
    ::close(fd);
    return nullptr;
  }
  if (st.st_size == 0) {  // empty file: valid, zero-record database
    ::close(fd);
    return new FastaDB();
  }
  const size_t size = static_cast<size_t>(st.st_size);
  const char* data =
      static_cast<const char*>(::mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0));
  ::close(fd);
  if (data == MAP_FAILED) return nullptr;
  ::madvise(const_cast<char*>(data), size, MADV_SEQUENTIAL);

  auto* db = new FastaDB();
  db->codes.reserve(size / 2);
  bool in_record = false;
  int64_t cur_start = 0;
  // Line semantics must match the pure-Python parser EXACTLY (io/fasta.py
  // strips each line, then tests startswith('>')): a '>' preceded only by
  // blanks since the line started begins a header; '\n' AND lone '\r'
  // both terminate lines (text-mode universal newlines in Python — the
  // old scanner skipped to '\n' only, so CR-only files lost all sequence
  // data); headers are trimmed of surrounding blanks like Python's
  // line[1:].strip(). A mid-line '>' stays sequence content, dropped by
  // the residue filter exactly as alphabet.encode drops it. Keeping the
  // two parsers byte-equivalent matters: which one runs depends on
  // whether the .so is built.
  bool ws_only = true;  // only blanks seen since the current line started
  size_t i = 0;
  while (i < size) {
    const char ch = data[i];
    if (ch == '\n' || ch == '\r') {
      ws_only = true;
      ++i;
      continue;
    }
    if (ch == ' ' || ch == '\t') {
      ++i;  // blanks never flip ws_only off by themselves
      continue;
    }
    if (ch == '>' && ws_only) {
      if (in_record) {
        db->lengths.push_back(
            static_cast<int32_t>(db->codes.size() - cur_start));
      }
      // Header runs to end of line; trim surrounding blanks.
      size_t j = i + 1;
      while (j < size && data[j] != '\n' && data[j] != '\r') ++j;
      size_t b = i + 1, e = j;
      while (b < e && (data[b] == ' ' || data[b] == '\t')) ++b;
      while (e > b && (data[e - 1] == ' ' || data[e - 1] == '\t')) --e;
      db->headers.append(data + b, e - b);
      db->headers.push_back('\0');
      db->offsets.push_back(static_cast<int64_t>(db->codes.size()));
      cur_start = static_cast<int64_t>(db->codes.size());
      in_record = true;
      i = j;  // the terminator (or EOF) is handled by the loop
      continue;
    }
    ws_only = false;
    if (!in_record) {
      // Body before any header: malformed.
      ::munmap(const_cast<char*>(data), size);
      delete db;
      return nullptr;
    }
    const unsigned char c = static_cast<unsigned char>(ch);
    if (is_residue(c)) db->codes.push_back(code_table[c]);
    ++i;
  }
  if (in_record) {
    db->lengths.push_back(static_cast<int32_t>(db->codes.size() - cur_start));
  }
  ::munmap(const_cast<char*>(data), size);
  return db;
}

int64_t fastadb_n_seqs(void* handle) {
  return static_cast<int64_t>(static_cast<FastaDB*>(handle)->lengths.size());
}

int64_t fastadb_total_residues(void* handle) {
  return static_cast<int64_t>(static_cast<FastaDB*>(handle)->codes.size());
}

int64_t fastadb_headers_size(void* handle) {
  return static_cast<int64_t>(static_cast<FastaDB*>(handle)->headers.size());
}

void fastadb_export(void* handle, uint8_t* codes_out, int64_t* offsets_out,
                    int32_t* lengths_out, char* headers_out) {
  auto* db = static_cast<FastaDB*>(handle);
  if (!db->codes.empty())
    std::memcpy(codes_out, db->codes.data(), db->codes.size());
  if (!db->offsets.empty()) {
    std::memcpy(offsets_out, db->offsets.data(),
                db->offsets.size() * sizeof(int64_t));
    std::memcpy(lengths_out, db->lengths.data(),
                db->lengths.size() * sizeof(int32_t));
  }
  if (!db->headers.empty())
    std::memcpy(headers_out, db->headers.data(), db->headers.size());
}

void fastadb_free(void* handle) { delete static_cast<FastaDB*>(handle); }

}  // extern "C"
