// Native FITS image reader (counterpart of cpp/fitsio_core.cpp, the
// reference's native core): parses the headers of an HDU and reads
// rectangular pixel boxes of its image straight off disk with pread,
// OpenMP-threaded, converting from big endian on the way. Built with the host
// C++ compiler at first use (pixell_tpu_torch/ops/_build.py, load_host) and
// loaded with ctypes by pixell_tpu_torch/fits_io.py.
//
// Its box reader, fits_read_box_strided, writes the box into a strided output
// (a piece of a larger buffer: the pieces of a box that wraps in RA land side
// by side in one output), reads boxes that span whole rows as contiguous
// chunks of several rows each, and reads small boxes in one thread.
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <fcntl.h>
#include <unistd.h>
#include <sys/stat.h>

extern "C" {

static const long BLOCK = 2880;

// Parse the headers up to HDU `hdu`, returning its data offset (bytes),
// bitpix, naxis, dims[8] (FITS order) and raw header text (into the caller's
// buffer). Returns 0 on success, -1 if the file cannot be opened, -2 on a
// truncated header, -3 if the file has fewer HDUs.
int fits_open_info(const char* fname, int hdu, long* data_offset, int* bitpix,
                   int* naxis, long* dims, char* header_buf, long header_cap,
                   long* header_len) {
    int fd = open(fname, O_RDONLY);
    if (fd < 0) return -1;
    long off = 0;
    int cur = 0;
    char block[BLOCK];
    *header_len = 0;
    while (1) {
        int bp = 0, nax = 0;
        long dd[9] = {0,0,0,0,0,0,0,0,0};
        bool done = false;
        long hlen = 0;
        while (!done) {
            ssize_t n = pread(fd, block, BLOCK, off);
            if (n < BLOCK) { close(fd); return -2; }
            off += BLOCK;
            for (int i = 0; i < BLOCK; i += 80) {
                char* card = block + i;
                if (cur == hdu && header_buf && hlen + 80 <= header_cap) {
                    memcpy(header_buf + hlen, card, 80);
                    hlen += 80;
                }
                if (strncmp(card, "END", 3) == 0 &&
                    (card[3] == ' ' || card[3] == '\0')) { done = true; break; }
                if (strncmp(card, "BITPIX  =", 9) == 0) bp = atoi(card + 9);
                if (strncmp(card, "NAXIS   =", 9) == 0) nax = atoi(card + 9);
                if (strncmp(card, "NAXIS", 5) == 0 && card[5] >= '1' && card[5] <= '8'
                    && card[8] == '=') {
                    int ax = card[5] - '0';
                    dd[ax] = atol(card + 9);
                }
            }
        }
        long dsize = 0;
        if (nax > 0) {
            dsize = labs((long)bp)/8;
            for (int a = 1; a <= nax; a++) dsize *= dd[a];
            dsize = (dsize + BLOCK - 1)/BLOCK*BLOCK;
        }
        if (cur == hdu) {
            *data_offset = off;
            *bitpix = bp;
            *naxis = nax;
            for (int a = 0; a < nax && a < 8; a++) dims[a] = dd[a+1];
            *header_len = hlen;
            close(fd);
            return 0;
        }
        off += dsize;
        cur++;
        struct stat st;
        if (fstat(fd, &st) == 0 && off >= st.st_size) { close(fd); return -3; }
    }
}

// big endian -> native, in place
static void byteswap(unsigned char* p, long n, int width) {
    if (width == 2) {
        uint16_t* q = (uint16_t*)p;
        for (long i = 0; i < n; i++) q[i] = __builtin_bswap16(q[i]);
    } else if (width == 4) {
        uint32_t* q = (uint32_t*)p;
        for (long i = 0; i < n; i++) q[i] = __builtin_bswap32(q[i]);
    } else if (width == 8) {
        uint64_t* q = (uint64_t*)p;
        for (long i = 0; i < n; i++) q[i] = __builtin_bswap64(q[i]);
    }
}

// pread of exactly n bytes (pread may return fewer for large requests)
static int pread_all(int fd, unsigned char* dst, long n, long off) {
    while (n > 0) {
        ssize_t k = pread(fd, dst, n, off);
        if (k <= 0) return -2;
        dst += k; off += k; n -= k;
    }
    return 0;
}

// Read the box rows [y1,y2) x cols [x1,x2) of every plane of the image
// [npre, ny, nx] (nx fastest, as FITS stores it) at data_offset into out, in
// native byte order. Element (p, y, x) of the box goes to
// out[p*out_planestride + (y-y1)*out_rowstride + (x-x1)], strides in
// elements. Boxes of whole rows whose output rows are contiguous are read in
// chunks of up to `chunk_rows` rows, one pread each. Returns 0 on success.
int fits_read_box_strided(const char* fname, long data_offset, int bitpix,
                          long npre, long ny, long nx,
                          long y1, long y2, long x1, long x2, unsigned char* out,
                          long out_rowstride, long out_planestride) {
    if (y2 <= y1 || x2 <= x1 || npre <= 0) return 0;
    int fd = open(fname, O_RDONLY);
    if (fd < 0) return -1;
    const int width = labs((long)bitpix)/8;
    const long ncol = x2 - x1;
    const long rowbytes = ncol*width;
    const long nrow = y2 - y1;
    // rows per task: whole rows with contiguous output rows are read
    // several at a time (contiguous on disk and in out), else one by one
    const bool whole = (x1 == 0 && x2 == nx && out_rowstride == ncol);
    long chunk_rows = whole ? (8L << 20)/rowbytes : 1;
    if (chunk_rows < 1) chunk_rows = 1;
    const long nchunk = (nrow + chunk_rows - 1)/chunk_rows;
    int err = 0;
    // small boxes in one thread: waking the team costs more than their reads
    #pragma omp parallel for collapse(2) schedule(dynamic) if(npre*nrow*rowbytes >= (4L << 20))
    for (long p = 0; p < npre; p++) {
        for (long c = 0; c < nchunk; c++) {
            long y = y1 + c*chunk_rows;
            long rows = y + chunk_rows < y2 ? chunk_rows : y2 - y;
            long src = data_offset + ((p*ny + y)*nx + x1)*width;
            unsigned char* dst = out + (p*out_planestride + (y - y1)*out_rowstride)*width;
            if (pread_all(fd, dst, rows*rowbytes, src) != 0) {
                #pragma omp atomic write
                err = -2;
            }
            byteswap(dst, rows*ncol, width);
        }
    }
    close(fd);
    return err;
}

}  // extern "C"
