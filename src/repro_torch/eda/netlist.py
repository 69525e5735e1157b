"""Template-based netlist generator (paper Sec. 3.3, "straightforward
engineering process" — spelled out here); a copy of `repro.eda.netlist`.

Hierarchy mirrors the synthesizable architecture (Fig. 6):
  macro
    column[j]  (x W)
      local_array[i]  (x H/L): L SRAM8T cells sharing one CAPLC
      rblsw[g]: CMOS switches isolating SAR cap groups on the RBL
      comp, sarlogic, dff[b] (x B_ADC): the column ADC
    rowdrv[r] (x H): RWL drivers shared across columns
Nets: per-column RBL (caps + switches + comparator), per-row RWL
(driver -> every column's cell in that row), SAR control P/N per column,
global CLK/RST.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.acim_spec import MacroSpec

# RWL rows beyond this are uniform repeats; netlist, placer and router
# all instantiate/route only this many row drivers to bound model size.
MAX_ROW_DRIVERS = 64


@dataclasses.dataclass(frozen=True)
class Instance:
    name: str
    cell: str


@dataclasses.dataclass(frozen=True)
class Net:
    name: str
    pins: tuple[tuple[str, str], ...]      # (instance_name, pin)


@dataclasses.dataclass(frozen=True)
class Netlist:
    spec: MacroSpec
    instances: tuple[Instance, ...]
    nets: tuple[Net, ...]

    def stats(self) -> dict:
        kinds: dict[str, int] = {}
        for inst in self.instances:
            kinds[inst.cell] = kinds.get(inst.cell, 0) + 1
        return {"instances": len(self.instances), "nets": len(self.nets),
                "by_cell": kinds}


def stats_for_spec(spec: MacroSpec) -> dict:
    """Closed-form `Netlist.stats()` without building the instance list.

    The hierarchy is regular, so the counts are pure arithmetic in the
    spec; the batched layout flow (`repro_torch.eda.batched_flow`) uses
    this to skip the per-instance Python of `generate` entirely.
    """
    n_la = spec.n_caps
    n_sw = len(spec.sar_groups()) - 1
    n_rd = min(spec.h, MAX_ROW_DRIVERS)
    by_cell = {
        "CAPLC": spec.w * n_la,
        "SRAM8T": spec.w * spec.h,
        "RBLSW": spec.w * n_sw,
        "COMP": spec.w,
        "SARLOGIC": spec.w,
        "DFF": spec.w * spec.b_adc,
        "ROWDRV": n_rd,
    }
    by_cell = {k: v for k, v in by_cell.items() if v}
    return {"instances": sum(by_cell.values()),
            "nets": spec.w * (spec.h + 3) + n_rd,
            "by_cell": by_cell}


def generate(spec: MacroSpec) -> Netlist:
    insts: list[Instance] = []
    nets: list[Net] = []
    n_la = spec.n_caps                      # local arrays per column
    groups = spec.sar_groups()

    for j in range(spec.w):
        col = f"c{j}"
        rbl_pins: list[tuple[str, str]] = []
        for i in range(n_la):
            cap = f"{col}_la{i}_cap"
            insts.append(Instance(cap, "CAPLC"))
            rbl_pins.append((cap, "BOT"))
            for k in range(spec.l):
                cell = f"{col}_la{i}_s{k}"
                insts.append(Instance(cell, "SRAM8T"))
                nets.append(Net(f"{col}_la{i}_top{k}",
                                ((cell, "RBL"), (cap, "TOP"))))
        # SAR group isolation switches along the RBL (paper Sec. 3.1)
        for g in range(len(groups) - 1):
            sw = f"{col}_sw{g}"
            insts.append(Instance(sw, "RBLSW"))
            rbl_pins.append((sw, "A"))
        comp = f"{col}_comp"
        sar = f"{col}_sar"
        insts.append(Instance(comp, "COMP"))
        insts.append(Instance(sar, "SARLOGIC"))
        rbl_pins.append((comp, "INP"))
        nets.append(Net(f"{col}_rbl", tuple(rbl_pins)))
        nets.append(Net(f"{col}_cmp", ((comp, "OUT"), (sar, "CMP"))))
        dff_pins = []
        for b in range(spec.b_adc):
            dff = f"{col}_dff{b}"
            insts.append(Instance(dff, "DFF"))
            dff_pins.append((dff, "D"))
        nets.append(Net(f"{col}_sar_bus", tuple([(sar, "DOUT")] + dff_pins)))

    # row drivers: one RWL per row crossing every column
    for r in range(min(spec.h, MAX_ROW_DRIVERS)):  # see MAX_ROW_DRIVERS;
        drv = f"rd{r}"                      # keep netlist size bounded, the
        insts.append(Instance(drv, "ROWDRV"))  # row template is uniform
        pins = [(drv, "OUT")]
        la, k = divmod(r, spec.l)
        for j in range(spec.w):
            pins.append((f"c{j}_la{la}_s{k}", "RWL"))
        nets.append(Net(f"rwl{r}", tuple(pins)))

    return Netlist(spec, tuple(insts), tuple(nets))
