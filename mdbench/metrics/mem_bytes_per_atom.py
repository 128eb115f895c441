"""Peak device bytes per atom: ``torch.cuda.max_memory_allocated`` over the
window (the peak reset after set-up), over the atoms on that card; on
several cards, the fullest card's peak over the atoms it held. It sets how
many atoms a card holds."""


def read(run):
    if run.memory_peak_bytes <= 0:
        return None
    return run.memory_peak_bytes / run.extra.get("atoms_on_card", run.atoms)
