"""A Yul-subset interpreter with EVM memory/precompile semantics.

Counterpart of `uzkge_tpu/evm/yul.py`, over this package's own host curve,
pairing and Keccak (curve/bn254.py, pcs/pairing.py, hash/keccak.py).  It
runs the inline-assembly blocks of the reference's Solidity verifier
contracts VERBATIM (PlonkVerifier.sol's `verifyProof` is one ~1800-line Yul
block), so that proof bytes can be accepted or rejected by the unchanged
on-chain verifier logic without an external toolchain (no solc or node).
Host code only: it runs no kernel.

Supported grammar (everything the verifier contracts use: the reference's
contracts/solidity/contracts/verifier/PlonkVerifier.sol,
shuffle/ShuffleVerifier.sol, shuffle/VerifierKey*.sol,
shuffle/ExternalTranscript.sol):

  block, let, assignment, if, for, function definitions (<=1 return value),
  literals (decimal / hex / true / false; the tokenizer takes no string
  literal, as the JAX package's does not, and raises SyntaxError on one),
  and the builtins
  add sub mul div mod mulmod addmod exp and or xor not shl shr lt gt eq
  iszero mload mstore mstore8 calldataload calldatasize keccak256
  staticcall gas pop return revert.

EVM semantics honored: 256-bit wraparound arithmetic, big-endian 32-byte
words in a byte-addressed auto-extending memory, div/mod-by-zero = 0,
keccak256 over raw memory, staticcall dispatch to precompiles 0x05-0x08
(modexp, BN254 ecAdd/ecMul/pairing) and to caller-registered contract
addresses.
"""

import re
from typing import Callable, Dict, List, Optional, Tuple

from ..constants.bn254 import Q_MOD, R_MOD
from ..hash.keccak import keccak256

WORD = 1 << 256
MASK = WORD - 1


class EvmReturn(Exception):
    def __init__(self, data: bytes):
        self.data = data


class EvmRevert(Exception):
    def __init__(self, data: bytes = b""):
        self.data = data


# ----------------------------------------------------------------- lexing

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<comment>//[^\n]*|/\*.*?\*/)
  | (?P<hex>0x[0-9a-fA-F]+)
  | (?P<dec>\d+)
  | (?P<ident>[A-Za-z_$][A-Za-z0-9_$.]*)
  | (?P<assign>:=)
  | (?P<arrow>->)
  | (?P<punct>[{}(),])
    """,
    re.VERBOSE | re.DOTALL,
)


def tokenize(src: str) -> List[str]:
    out = []
    pos = 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if not m:
            raise SyntaxError(f"yul: cannot tokenize at {src[pos:pos+40]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind in ("ws", "comment"):
            continue
        out.append(m.group())
    return out


# ---------------------------------------------------------------- parsing
# AST node shapes (tuples):
#   ("block", [stmts])          ("let", name, expr|None)
#   ("assign", name, expr)      ("if", cond, block)
#   ("for", init_block, cond, post_block, body_block)
#   ("fundef", name, [params], ret|None, block)
#   ("call", name, [args])      ("ident", name)     ("lit", int)


class Parser:
    def __init__(self, tokens: List[str]):
        self.toks = tokens
        self.i = 0

    def peek(self) -> Optional[str]:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self) -> str:
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, t: str):
        got = self.next()
        if got != t:
            raise SyntaxError(f"yul: expected {t!r}, got {got!r} at token {self.i}")

    def parse_block(self):
        self.expect("{")
        stmts = []
        while self.peek() != "}":
            stmts.append(self.parse_statement())
        self.expect("}")
        return ("block", stmts)

    def parse_statement(self):
        t = self.peek()
        if t == "{":
            return self.parse_block()
        if t == "let":
            self.next()
            name = self.next()
            expr = None
            if self.peek() == ":=":
                self.next()
                expr = self.parse_expr()
            return ("let", name, expr)
        if t == "if":
            self.next()
            cond = self.parse_expr()
            return ("if", cond, self.parse_block())
        if t == "for":
            self.next()
            init = self.parse_block()
            cond = self.parse_expr()
            post = self.parse_block()
            body = self.parse_block()
            return ("for", init, cond, post, body)
        if t == "function":
            self.next()
            name = self.next()
            self.expect("(")
            params = []
            while self.peek() != ")":
                params.append(self.next())
                if self.peek() == ",":
                    self.next()
            self.expect(")")
            ret = None
            if self.peek() == "->":
                self.next()
                ret = self.next()
            return ("fundef", name, params, ret, self.parse_block())
        # assignment or expression statement
        expr = self.parse_expr()
        if self.peek() == ":=":
            if expr[0] != "ident":
                raise SyntaxError("yul: bad assignment target")
            self.next()
            return ("assign", expr[1], self.parse_expr())
        return expr

    def parse_expr(self):
        t = self.next()
        if t == "true":
            return ("lit", 1)
        if t == "false":
            return ("lit", 0)
        if t.startswith("0x"):
            return ("lit", int(t, 16))
        if t.isdigit():
            return ("lit", int(t))
        if self.peek() == "(":
            self.next()
            args = []
            while self.peek() != ")":
                args.append(self.parse_expr())
                if self.peek() == ",":
                    self.next()
            self.expect(")")
            return ("call", t, args)
        return ("ident", t)


def parse_block(src: str):
    return Parser(tokenize(src)).parse_block()


# ------------------------------------------------------------- precompiles


def _g1_from_words(x: int, y: int):
    if x == 0 and y == 0:
        return None
    return (x, y)


def _g1_to_words(p) -> Tuple[int, int]:
    return (0, 0) if p is None else (p[0] % Q_MOD, p[1] % Q_MOD)


def precompile(addr: int, data: bytes) -> Optional[bytes]:
    """EVM precompiles 0x05-0x08 on this package's host curve and pairing
    math.  Returns output bytes, or None for a failure (invalid point)."""
    from ..curve.bn254 import g1_add, g1_mul, g1_is_on_curve

    if addr == 5:  # modexp (EIP-198)
        bl = int.from_bytes(data[0:32], "big")
        el = int.from_bytes(data[32:64], "big")
        ml = int.from_bytes(data[64:96], "big")
        off = 96
        base = int.from_bytes(data[off : off + bl], "big")
        exp = int.from_bytes(data[off + bl : off + bl + el], "big")
        mod = int.from_bytes(data[off + bl + el : off + bl + el + ml], "big")
        out = 0 if mod == 0 else pow(base, exp, mod)
        return out.to_bytes(ml, "big")
    if addr == 6:  # BN254 ecAdd
        x0, y0, x1, y1 = (int.from_bytes(data[i * 32 : (i + 1) * 32], "big") for i in range(4))
        p0, p1 = _g1_from_words(x0, y0), _g1_from_words(x1, y1)
        for p in (p0, p1):
            if p is not None and not g1_is_on_curve(p):
                return None
        r = g1_add(p0, p1)
        x, y = _g1_to_words(r)
        return x.to_bytes(32, "big") + y.to_bytes(32, "big")
    if addr == 7:  # BN254 ecMul
        x0, y0, s = (int.from_bytes(data[i * 32 : (i + 1) * 32], "big") for i in range(3))
        p0 = _g1_from_words(x0, y0)
        if p0 is not None and not g1_is_on_curve(p0):
            return None
        r = g1_mul(p0, s) if p0 is not None else None
        x, y = _g1_to_words(r)
        return x.to_bytes(32, "big") + y.to_bytes(32, "big")
    if addr == 8:  # BN254 pairing check
        from ..pcs.pairing import multi_pairing_is_one

        if len(data) % 192 != 0:
            return None
        pairs = []
        for i in range(len(data) // 192):
            c = data[i * 192 : (i + 1) * 192]
            g1x, g1y = int.from_bytes(c[0:32], "big"), int.from_bytes(c[32:64], "big")
            # G2 coords: imaginary limb first (EIP-197)
            x_im, x_re = int.from_bytes(c[64:96], "big"), int.from_bytes(c[96:128], "big")
            y_im, y_re = int.from_bytes(c[128:160], "big"), int.from_bytes(c[160:192], "big")
            p1 = _g1_from_words(g1x, g1y)
            if p1 is None:
                continue  # e(O, Q) = 1
            if not g1_is_on_curve(p1):
                return None
            pairs.append((p1, ((x_re, x_im), (y_re, y_im))))
        ok = multi_pairing_is_one(pairs) if pairs else True
        return int(ok).to_bytes(32, "big")
    return None


# ------------------------------------------------------------ interpreter


class YulVM:
    """Executes parsed Yul blocks against EVM-style memory + calldata.

    `contracts`: address -> callable(data: bytes) -> Optional[bytes]
    handling staticcalls to non-precompile addresses (the VerifierKeyExtra
    data contracts)."""

    def __init__(self, calldata: bytes = b"",
                 contracts: Optional[Dict[int, Callable]] = None):
        self.memory = bytearray()
        self.calldata = calldata
        self.contracts = contracts or {}
        self.functions: Dict[str, tuple] = {}

    # ---- memory helpers
    def _ensure(self, end: int):
        if end > len(self.memory):
            self.memory.extend(b"\x00" * (end - len(self.memory)))

    def mload(self, off: int) -> int:
        self._ensure(off + 32)
        return int.from_bytes(self.memory[off : off + 32], "big")

    def mstore(self, off: int, val: int):
        self._ensure(off + 32)
        self.memory[off : off + 32] = (val & MASK).to_bytes(32, "big")

    def mstore8(self, off: int, val: int):
        self._ensure(off + 1)
        self.memory[off] = val & 0xFF

    def mslice(self, off: int, length: int) -> bytes:
        self._ensure(off + length)
        return bytes(self.memory[off : off + length])

    def mwrite(self, off: int, data: bytes):
        self._ensure(off + len(data))
        self.memory[off : off + len(data)] = data

    # ---- execution
    def run(self, block, env: Dict[str, int]):
        """Execute a block with `env` as the outer scope (Solidity locals /
        constants / function args).  Mutates env for assignments to outer
        names.  `env` is also visible inside Yul function bodies — matching
        solc, where references to Solidity `constant`s in assembly are
        substituted at compile time."""
        self._collect_functions(block)
        self.global_env = env
        self._exec_block(block, [env])

    def _collect_functions(self, block):
        for st in block[1]:
            if st[0] == "fundef":
                self.functions[st[1]] = st
            elif st[0] == "block":
                self._collect_functions(st)

    def _exec_block(self, block, scopes: List[dict]):
        scopes.append({})
        try:
            for st in block[1]:
                self._exec_stmt(st, scopes)
        finally:
            scopes.pop()

    def _exec_stmt(self, st, scopes):
        op = st[0]
        if op == "block":
            self._exec_block(st, scopes)
        elif op == "let":
            scopes[-1][st[1]] = self._eval(st[2], scopes) if st[2] is not None else 0
        elif op == "assign":
            val = self._eval(st[2], scopes)
            for sc in reversed(scopes):
                if st[1] in sc:
                    sc[st[1]] = val
                    return
            raise NameError(f"yul: assignment to undeclared {st[1]}")
        elif op == "if":
            if self._eval(st[1], scopes):
                self._exec_block(st[2], scopes)
        elif op == "for":
            _, init, cond, post, body = st
            scopes.append({})
            try:
                for s in init[1]:
                    self._exec_stmt(s, scopes)
                while self._eval(cond, scopes):
                    self._exec_block(body, scopes)
                    for s in post[1]:
                        self._exec_stmt(s, scopes)
            finally:
                scopes.pop()
        elif op == "fundef":
            pass  # hoisted by _collect_functions
        elif op == "call":
            self._eval(st, scopes)
        else:
            raise SyntaxError(f"yul: bad statement {op}")

    def _eval(self, expr, scopes) -> int:
        op = expr[0]
        if op == "lit":
            return expr[1]
        if op == "ident":
            name = expr[1]
            for sc in reversed(scopes):
                if name in sc:
                    return sc[name]
            raise NameError(f"yul: undefined identifier {name}")
        # call
        name, args = expr[1], expr[2]
        if name in self.functions:
            fd = self.functions[name]
            vals = [self._eval(a, scopes) for a in args]
            fscope = dict(zip(fd[2], vals))
            if fd[3] is not None:
                fscope[fd[3]] = 0
            # function bodies see their own scope + the global constants
            inner = [self.global_env, fscope]
            self._exec_block(fd[4], inner)
            return fscope[fd[3]] if fd[3] is not None else 0
        return self._builtin(name, args, scopes)

    def _builtin(self, name, args, scopes) -> int:
        ev = lambda i: self._eval(args[i], scopes)
        if name == "add":
            return (ev(0) + ev(1)) & MASK
        if name == "sub":
            return (ev(0) - ev(1)) & MASK
        if name == "mul":
            return (ev(0) * ev(1)) & MASK
        if name == "div":
            a, b = ev(0), ev(1)
            return a // b if b else 0
        if name == "mod":
            a, b = ev(0), ev(1)
            return a % b if b else 0
        if name == "mulmod":
            a, b, m = ev(0), ev(1), ev(2)
            return (a * b) % m if m else 0
        if name == "addmod":
            a, b, m = ev(0), ev(1), ev(2)
            return (a + b) % m if m else 0
        if name == "exp":
            return pow(ev(0), ev(1), WORD)
        if name == "and":
            return ev(0) & ev(1)
        if name == "or":
            return ev(0) | ev(1)
        if name == "xor":
            return ev(0) ^ ev(1)
        if name == "not":
            return ev(0) ^ MASK
        if name == "shl":
            s = ev(0)
            return (ev(1) << s) & MASK if s < 256 else 0
        if name == "shr":
            s = ev(0)
            return ev(1) >> s if s < 256 else 0
        if name == "lt":
            return int(ev(0) < ev(1))
        if name == "gt":
            return int(ev(0) > ev(1))
        if name == "eq":
            return int(ev(0) == ev(1))
        if name == "iszero":
            return int(ev(0) == 0)
        if name == "mload":
            return self.mload(ev(0))
        if name == "mstore":
            self.mstore(ev(0), ev(1))
            return 0
        if name == "mstore8":
            self.mstore8(ev(0), ev(1))
            return 0
        if name == "calldataload":
            off = ev(0)
            chunk = self.calldata[off : off + 32]
            return int.from_bytes(chunk.ljust(32, b"\x00"), "big")
        if name == "calldatasize":
            return len(self.calldata)
        if name == "keccak256":
            return int.from_bytes(keccak256(self.mslice(ev(0), ev(1))), "big")
        if name == "gas":
            return 10**9
        if name == "pop":
            ev(0)
            return 0
        if name == "staticcall":
            _gas, addr, in_off, in_len, out_off, out_len = (ev(i) for i in range(6))
            data = self.mslice(in_off, in_len)
            if addr in self.contracts:
                out = self.contracts[addr](data)
            else:
                out = precompile(addr, data)
            if out is None:
                return 0
            self.mwrite(out_off, out[:out_len].ljust(out_len, b"\x00") if len(out) < out_len else out[:out_len])
            return 1
        if name == "return":
            raise EvmReturn(self.mslice(ev(0), ev(1)))
        if name == "revert":
            raise EvmRevert(self.mslice(ev(0), ev(1)))
        raise NameError(f"yul: unknown builtin {name}")


# ------------------------------------------------- Solidity source helpers


def extract_constants(sol_src: str) -> Dict[str, int]:
    """Parse `uintN [internal] constant NAME = <int-expr>;` declarations."""
    out = {}
    for m in re.finditer(
        r"uint(?:256|128|64|32|16|8)\s+(?:internal\s+)?constant\s+(\w+)\s*=\s*([^;]+);", sol_src
    ):
        expr = m.group(2).strip()
        if not re.fullmatch(r"[0-9a-fA-FxX+\-*() \n]+", expr):
            raise ValueError(f"unsupported constant expr: {expr}")
        out[m.group(1)] = eval(expr, {"__builtins__": {}})  # arithmetic only
    return out


def extract_assembly_blocks(sol_src: str) -> List[str]:
    """Return the bodies (incl. braces) of every inline `assembly { ... }`
    block, in source order."""
    out = []
    for m in re.finditer(r"\bassembly\s*\{", sol_src):
        start = m.end() - 1
        depth = 0
        i = start
        in_comment = None
        while i < len(sol_src):
            if in_comment == "//":
                if sol_src[i] == "\n":
                    in_comment = None
            elif in_comment == "/*":
                if sol_src.startswith("*/", i):
                    in_comment = None
                    i += 1
            elif sol_src.startswith("//", i):
                in_comment = "//"
            elif sol_src.startswith("/*", i):
                in_comment = "/*"
            elif sol_src[i] == "{":
                depth += 1
            elif sol_src[i] == "}":
                depth -= 1
                if depth == 0:
                    out.append(sol_src[start : i + 1])
                    break
            i += 1
    return out
