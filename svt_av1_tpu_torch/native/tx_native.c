/*
 * Native interpreter for the extracted AV1 butterfly stage tables.
 *
 * Executes the same ops/data/txfm_stages.npz statement tables as the
 * numpy/jnp interpreter in svt_av1_tpu_torch/ops/transforms.py (single source
 * of truth for the networks); used for the host-side sequential coding
 * loop where per-stage numpy dispatch dominates.  Exercised against the
 * C oracle by tests/test_transforms.py (it is the default xp=np path)
 * and against the Python interpreter by tests/test_native_block.py.
 *
 * apply_network(x int32[batch, n], stmts int32[k, 5], offsets int32[s+1],
 *               clamp uint8[k], cospi int32[64], cos_bit, clamp_bit)
 *   -> int32[batch, n_out]   (modifies nothing; returns new array)
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <string.h>

#define KIND_BTF 1

static PyObject *apply_network(PyObject *self, PyObject *args) {
    Py_buffer xv, stv, ov, cv, cpv;
    int cos_bit, clamp_bit;
    Py_ssize_t batch, n;
    if (!PyArg_ParseTuple(args, "y*y*y*y*y*iinn",
                          &xv, &stv, &ov, &cv, &cpv,
                          &cos_bit, &clamp_bit, &batch, &n))
        return NULL;
    const int32_t *x0 = (const int32_t *)xv.buf;
    const int32_t *stmts = (const int32_t *)stv.buf;
    const int32_t *offs = (const int32_t *)ov.buf;
    const int8_t *clamp = (const int8_t *)cv.buf;
    const int32_t *cospi = (const int32_t *)cpv.buf;
    Py_ssize_t n_stages = ov.len / 4 - 1;

    int32_t cmax = clamp_bit > 0 ? (int32_t)((1u << (clamp_bit - 1)) - 1) : 0;
    int32_t cmin = clamp_bit > 0 ? (int32_t)(-(1 << (clamp_bit - 1))) : 0;
    int32_t rnd = 1 << (cos_bit - 1);

    /* output size = size of last stage */
    Py_ssize_t n_out = offs[n_stages] - offs[n_stages - 1];

    int32_t bufa[64], bufb[64];

    PyObject *out = PyBytes_FromStringAndSize(NULL, batch * n_out * 4);
    if (!out) goto fail;
    int32_t *res = (int32_t *)PyBytes_AS_STRING(out);

    for (Py_ssize_t b = 0; b < batch; ++b) {
        const int32_t *src = x0 + b * n;
        int32_t *cur = bufa, *nxt = bufb;
        memcpy(cur, src, n * sizeof(int32_t));
        Py_ssize_t cur_len = n;
        for (Py_ssize_t s = 0; s < n_stages; ++s) {
            const int32_t *st = stmts + offs[s] * 5;
            const int8_t *cl = clamp + offs[s];
            Py_ssize_t m = offs[s + 1] - offs[s];
            for (Py_ssize_t i = 0; i < m; ++i) {
                int kind = st[i * 5 + 0];
                int32_t ca = st[i * 5 + 1];
                int32_t ia = st[i * 5 + 2];
                int32_t cb = st[i * 5 + 3];
                int32_t ib = st[i * 5 + 4];
                int32_t v;
                if (kind == KIND_BTF) {
                    int32_t wa = ca < 0 ? -cospi[-ca - 1] : cospi[ca - 1];
                    int32_t wb = cb < 0 ? -cospi[-cb - 1]
                               : (cb > 0 ? cospi[cb - 1] : 0);
                    /* int32 wraparound semantics, as in the numpy path */
                    int32_t pa = (int32_t)((uint32_t)wa * (uint32_t)cur[ia]);
                    int32_t pb = (int32_t)((uint32_t)wb * (uint32_t)cur[ib]);
                    int32_t sum = (int32_t)((uint32_t)pa + (uint32_t)pb
                                            + (uint32_t)rnd);
                    v = sum >> cos_bit;
                } else {
                    v = (int32_t)((uint32_t)ca * (uint32_t)cur[ia]
                                  + (uint32_t)cb * (uint32_t)cur[ib]);
                    if (clamp_bit > 0 && cl[i]) {
                        if (v > cmax) v = cmax;
                        else if (v < cmin) v = cmin;
                    }
                }
                nxt[i] = v;
            }
            cur_len = m;
            int32_t *t = cur; cur = nxt; nxt = t;
        }
        memcpy(res + b * n_out, cur, n_out * sizeof(int32_t));
        (void)cur_len;
    }

    PyBuffer_Release(&xv); PyBuffer_Release(&stv); PyBuffer_Release(&ov);
    PyBuffer_Release(&cv); PyBuffer_Release(&cpv);
    {
        PyObject *np = PyImport_ImportModule("numpy");
        if (!np) { Py_DECREF(out); return NULL; }
        PyObject *fb = PyObject_CallMethod(np, "frombuffer", "Os", out, "int32");
        Py_DECREF(np);
        if (!fb) { Py_DECREF(out); return NULL; }
        PyObject *shaped = PyObject_CallMethod(fb, "reshape", "nn", batch, n_out);
        Py_DECREF(fb);
        Py_DECREF(out);
        return shaped;
    }
fail:
    PyBuffer_Release(&xv); PyBuffer_Release(&stv); PyBuffer_Release(&ov);
    PyBuffer_Release(&cv); PyBuffer_Release(&cpv);
    return NULL;
}

static PyMethodDef methods[] = {
    {"apply_network", apply_network, METH_VARARGS, NULL},
    {NULL, NULL, 0, NULL},
};

static PyModuleDef mod = {
    PyModuleDef_HEAD_INIT, "tx_native",
    "Native butterfly stage-table interpreter", -1, methods,
};

PyMODINIT_FUNC PyInit_tx_native(void) { return PyModule_Create(&mod); }
